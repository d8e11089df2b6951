"""Multi-process helpers of the port's data-parallel tests (not collected).

``run_ranks(mode, world, payload)`` starts ``world`` processes of this
file on the CPU, each with the environment a ``torchrun`` launch gives
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), so that ``parallel/mesh.py`` joins a gloo group; each
runs ``mode`` on ``payload`` (a JSON dict) and writes its result where the
payload says. Every launch has its own timeout. The worker imports nothing
of JAX.

Modes:
- ``step``: restore the train state ``payload["state"]`` (a checkpoint),
  ``shard_state`` it, and run ``payload["steps"]`` train steps on the
  global batches of ``payload["batches"]`` (``shard_batch`` of each), each
  from the state of the step before or, where ``payload["states"]`` lists
  checkpoints, from its own; write each step's losses and this rank's state
  after it, and this rank's ``make_global_batch`` / ``local_rows`` of the
  first batch's rows.
- ``augment``: ``make_augment_fn(rank, world)`` on this rank's rows of the
  batch in ``payload["batch"]``, with ``step_generator(seed, 0, 0)``.
- ``cli``: ``cli.train.main(payload["argv"])`` (``{rank}`` in an argument
  is this rank) with its output captured; write the return code, the
  printed valid mAPs, the local train sample count and each generator's
  batch count.
- ``serve``: ``InferenceModel.from_bundle(payload["bundle"], mesh=...)``
  on a data-parallel mesh of every rank (rank 0's parameters: the other
  ranks perturb theirs first), ``run_scores`` and ``run`` of the images in
  ``payload["images"]``; write this rank's detections and result, and the
  message of a batch that does not divide. With ``payload["one"]``, the
  same in one process with ``mesh=None``.
- ``tp_step``: a ``make_mesh(model=2)`` mesh; the state ``payload["state"]``
  placed by ``shard_state(tensor_parallel=True)``; per batch of
  ``payload["batches"]`` a train step (and with ``payload["remat"]`` the
  same step under remat) saved through ``save_checkpoint`` (whole leaves,
  rank 0 writes), then restored and sharded again for the next; the
  eval step's losses, the shards' shapes and the unsharded L2; and the
  first step of a data-parallel state placed on a data-only mesh made
  before the ``model=2`` one (it averages over its own mesh).
- ``cli_serve``: ``cli.detect.main`` or ``cli.infer.main`` (``payload["cli"]``)
  of ``payload["argv"]`` (``{rank}`` in an argument is this rank); write
  the return code and the output.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run_ranks(mode: str, world: int, payload: dict, timeout: float = 240.0):
    """Run ``mode`` on ``world`` gloo ranks (``parallel/mesh.spawn``, 2
    threads each); returns their outputs. Fails (and kills every rank) when
    one exits non-zero or the timeout passes."""
    from ssd_tensorflow_tpu_torch.parallel.mesh import spawn

    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    return spawn(world, [sys.executable, __file__, mode, json.dumps(payload)], timeout, env=env,
                 cwd=str(ROOT), capture=True)


def _train_cfg(spec: dict):
    from ssd_tensorflow_tpu_torch.models.ssd_vgg import ModelConfig
    from ssd_tensorflow_tpu_torch.ops.postprocess import DetectionConfig
    from ssd_tensorflow_tpu_torch.parallel.train_step import TrainConfig

    return TrainConfig(model=ModelConfig(preset_name=spec["preset"], num_classes=spec["k"],
                                         compute_dtype=spec["dtype"]),
                       detect=DetectionConfig(top_k=spec["top_k"],
                                              confidence_threshold=spec["threshold"]),
                       remat=spec.get("remat", False))


def _step(payload):
    import numpy as np
    import torch

    from ssd_tensorflow_tpu_torch.models.ssd_vgg import init_params
    from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
    from ssd_tensorflow_tpu_torch.parallel import multihost
    from ssd_tensorflow_tpu_torch.parallel.mesh import make_mesh, world
    from ssd_tensorflow_tpu_torch.parallel.train_step import (
        make_train_state,
        make_train_step,
        shard_batch,
        shard_state,
    )
    from ssd_tensorflow_tpu_torch.utils.checkpoint import restore_checkpoint, train_state_to_jax

    cfg = _train_cfg(payload["cfg"])
    mesh = make_mesh(device="cpu")
    rank, _ = world()
    template = make_train_state(init_params(cfg.model), cfg, device="cpu")
    state = shard_state(restore_checkpoint(payload["state"], template), mesh)
    step = make_train_step(cfg, anchors_for_preset(cfg.model.preset))
    with np.load(payload["batches"]) as f:
        batches = {k: f[k] for k in f.files}
    out = payload["out"]
    losses, digests = [], []
    for i in range(payload["steps"]):
        if payload.get("states"):  # each step from a given state
            state = shard_state(restore_checkpoint(payload["states"][i], template), mesh)
        state, l, _ = step(state, shard_batch({k: v[i] for k, v in batches.items()}, mesh))
        losses.append({k: float(v) for k, v in l.items()})
        host = train_state_to_jax(state)
        names = [(n, k) for n in sorted(host["params"]) for k in sorted(host["params"][n])]
        leaves = [host[t][n][k] for t in ("params", "trace") for n, k in names]
        digest = hashlib.sha256(b"".join(np.ascontiguousarray(x).tobytes() for x in leaves))
        digests.append(digest.hexdigest() + f":{state.opt_state.count}:{state.step}")
        if rank == 0:
            np.savez(f"{out}.step{i}.params.npz", *leaves[:len(names)])
    rows = multihost.process_shard(np.arange(len(batches["images"][0])))
    local = multihost.make_global_batch({"images": batches["images"][0][rows]}, mesh)
    host = multihost.local_rows_many([local["images"], torch.as_tensor(rows)])
    np.savez(f"{out}.rank{rank}.npz", images=host[0], rows=host[1])
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump({"losses": losses, "digests": digests, "step": state.step,
                   "count": state.opt_state.count}, f)


def _augment(payload):
    import numpy as np

    from ssd_tensorflow_tpu_torch.data.device_augment import (
        augment_config_for,
        make_augment_fn,
        step_generator,
    )
    from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
    from ssd_tensorflow_tpu_torch.parallel.mesh import make_mesh, world
    from ssd_tensorflow_tpu_torch.parallel.sharding import batch_rows
    from ssd_tensorflow_tpu_torch.presets import get_preset_by_name

    make_mesh(device="cpu")
    rank, size = world()
    preset = get_preset_by_name(payload["preset"])
    fn = make_augment_fn(augment_config_for(preset, payload["aug"]), anchors_for_preset(preset),
                         rank=rank, world=size)
    with np.load(payload["batch"]) as f:
        rows = batch_rows(len(f["images"]))
        batch = {k: f[k][rows] for k in f.files}
    out = fn(step_generator(payload["seed"], 0, 0, "cpu"), batch)
    np.savez(f"{payload['out']}.rank{rank}.npz", **{k: v.numpy() for k, v in out.items()})


def _cli(payload):
    import ssd_tensorflow_tpu_torch.cli.train as train_cli
    from ssd_tensorflow_tpu_torch.parallel.mesh import world

    batch_counts = []
    orig = train_cli.prefetch_to_device

    def counting_prefetch(gen, **kw):
        def run():
            n = 0
            for item in orig(gen, **kw):
                n += 1
                yield item
            batch_counts.append(n)

        return run()

    train_cli.prefetch_to_device = counting_prefetch
    buf = io.StringIO()
    stdout, sys.stdout = sys.stdout, buf
    try:
        rank = int(os.environ["RANK"])
        rc = train_cli.main([a.format(rank=rank) for a in payload["argv"]])
    finally:
        sys.stdout = stdout
    log = buf.getvalue()
    sys.stdout.write(log)
    local = re.search(r"(\d+) local train samples", log)
    with open(payload["out"].format(rank=rank), "w") as f:
        json.dump({"rc": rc, "batch_counts": batch_counts, "world": world()[1],
                   "valid_maps": [float(m) for m in re.findall(r"valid mAP ([0-9.]+)", log)],
                   "local_train_samples": int(local.group(1)) if local else None}, f)


def _dets_arrays(dets, prefix=""):
    return {prefix + f: getattr(dets, f).numpy() for f in ("boxes", "scores", "classes", "valid")}


def _serve(payload):
    import numpy as np
    import torch

    from ssd_tensorflow_tpu_torch.inference import InferenceModel, load_bundle
    from ssd_tensorflow_tpu_torch.ops.postprocess import DetectionConfig
    from ssd_tensorflow_tpu_torch.parallel.mesh import make_mesh, world

    mesh = None if payload.get("one") else make_mesh(device="cpu")
    rank, _ = world()
    params, cfg, lid2name, act_scales = load_bundle(payload["bundle"])
    if rank:  # replicated from rank 0: another rank's own values must not count
        params = {n: {k: v + 1 if v.dtype == torch.float32 else v for k, v in d.items()}
                  for n, d in params.items()}
    model = InferenceModel(params, cfg, lid2name, act_scales=act_scales, device="cpu",
                           detection=DetectionConfig(**payload["detection"]), mesh=mesh)
    with np.load(payload["images"]) as f:
        images = f["images"]
    out = _dets_arrays(model.run_scores(images))
    result, dets = model.run(torch.from_numpy(images))
    out.update(_dets_arrays(dets, "run_"), result=result.numpy())
    try:
        model.run_scores(images[:len(images) - 1])
        out["indivisible"] = np.array("")
    except ValueError as e:
        out["indivisible"] = np.array(str(e))
    np.savez(f"{payload['out']}.rank{rank}.npz", **out)


def _tp_step(payload):
    import numpy as np

    from ssd_tensorflow_tpu_torch.models.loss import l2_regularizer
    from ssd_tensorflow_tpu_torch.models.ssd_vgg import init_params
    from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
    from ssd_tensorflow_tpu_torch.parallel.mesh import make_mesh, world
    from ssd_tensorflow_tpu_torch.parallel.sharding import batch_rows
    from ssd_tensorflow_tpu_torch.parallel.tensor_parallel import model_shards
    from ssd_tensorflow_tpu_torch.parallel.train_step import (
        make_eval_step,
        make_train_state,
        make_train_step,
        shard_batch,
        shard_state,
    )
    from ssd_tensorflow_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    cfg = _train_cfg(payload["cfg"])
    dp_mesh = make_mesh(device="cpu")
    mesh = make_mesh(model=2, device="cpu")
    rank, _ = world()
    template = make_train_state(init_params(cfg.model), cfg, device="cpu")
    anchors = anchors_for_preset(cfg.model.preset)
    steps = {"": make_train_step(cfg, anchors)}
    if payload.get("remat"):
        import dataclasses

        steps[".remat"] = make_train_step(dataclasses.replace(cfg, remat=True), anchors)
    with np.load(payload["batches"]) as f:
        batches = {k: f[k] for k in f.files}
    out, report = payload["out"], {"losses": [], "shapes": {}}
    start = payload["state"]
    for i in range(len(batches["images"])):
        batch = {k: v[i] for k, v in batches.items()}
        state = shard_state(restore_checkpoint(start, template), mesh, tensor_parallel=True)
        if i == 0:
            report["shapes"] = {f"{t}/{n}/{k}": list(tree[n][k].shape)
                                for t, tree in (("params", state.params),
                                                ("trace", state.opt_state.trace))
                                for n in ("mod_conv6", "mod_conv7") for k in ("w", "b")}
            report["l2"] = float(l2_regularizer(state.params, model_shards(mesh)))
            evaluate = make_eval_step(cfg, anchors, mesh=mesh, tensor_parallel=True)
            report["eval"] = {k: float(v) for k, v in evaluate(
                state.params, shard_batch(batch, mesh))[0].items()}
            rows = batch_rows(len(batch["images"]), mesh)
            report["rows"] = [rows.start, rows.stop]
            dp_state = shard_state(restore_checkpoint(start, template), dp_mesh)
            report["dp_losses"] = {k: float(v) for k, v in steps[""](
                dp_state, shard_batch(batch, dp_mesh))[1].items()}
        for suffix, step in steps.items():
            new, losses, _ = step(state, shard_batch(batch, mesh))
            save_checkpoint(f"{out}.step{i}{suffix}.ckpt.npz", new)
            if not suffix:
                report["losses"].append({k: float(v) for k, v in losses.items()})
            else:
                report["remat_losses"] = {k: float(v) for k, v in losses.items()}
        start = f"{out}.step{i}.ckpt.npz"
        steps.pop(".remat", None)
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump(report, f)


def _cli_serve(payload):
    import importlib

    from ssd_tensorflow_tpu_torch.parallel.mesh import world

    cli = importlib.import_module(f"ssd_tensorflow_tpu_torch.cli.{payload['cli']}")
    rank = int(os.environ["RANK"])
    buf = io.StringIO()
    stdout, sys.stdout = sys.stdout, buf
    try:
        rc = cli.main([a.format(rank=rank) for a in payload["argv"]])
    finally:
        sys.stdout = stdout
    sys.stdout.write(buf.getvalue())
    assert world() == (rank, int(os.environ["WORLD_SIZE"]))
    with open(payload["out"].format(rank=rank), "w") as f:
        json.dump({"rc": rc, "log": buf.getvalue()}, f)


if __name__ == "__main__":
    sys.modules["jax"] = None  # the port runs without JAX
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(2)
    mode, payload = sys.argv[1], json.loads(sys.argv[2])
    try:
        {"step": _step, "augment": _augment, "cli": _cli, "serve": _serve, "tp_step": _tp_step,
         "cli_serve": _cli_serve}[mode](payload)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
