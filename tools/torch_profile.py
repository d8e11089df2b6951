#!/usr/bin/env python3
"""Where the time goes on the port's detection paths, on one GPU.

    python3 tools/torch_profile.py [--seed 0] [--batch 64] [--stem-variant dma|uint8]
                                   [--preset vgg512|resnet320|mobilenet320]
                                   [--bundle assets/vgg512_int8_minivoc.ssdtpu.npz]
                                   [--out runs/torch_profile.json]
    python3 tools/torch_profile.py --train [--batch 32] [--out ...]
    python3 tools/torch_profile.py --qat mobilenet320|vgg512 [--batch 32|8] [--out ...]

Without ``--bundle``: ``--preset`` (vgg512 by default) bf16 with weights
made from the seed, a vgg512 model's stem kernel chosen as
``InferenceModel(overrides={"pallas_stem_variant": ...})`` does. With
``--bundle``: that bundle through ``InferenceModel.from_bundle`` (an int8
bundle runs the int8 W8A8 path; the family bundles
``assets/resnet320_int8_minicoco.ssdtpu.npz`` and
``assets/mobilenet320_int8_qat_minivoc.ssdtpu.npz`` their folded int8
walk). Random uint8 images from the seed either way. Prints one JSON
object (and writes it to ``--out``):

* ``stages``: each layer of the path timed alone with CUDA events on the
  inputs the path gives it, in ms per batch. Float path: preprocess +
  conv1_1 and the split stem kernel, or the whole uint8 stem kernel; the
  rest of the VGG trunk, L2-norm + extras, heads + lazy softmax, top-k +
  decode + clamp, class shift + the NMS kernel, compaction. int8 path:
  preprocess, ``int8_conv`` (every trunk and extra conv's call of the
  fused kernel, ``ops/int8_conv.int8_qconv``, timed alone); then pools
  + L2-norm (VGG) or GroupNorm with its activation and skip add
  (``resnet.norm_act``) and the depthwise convs (families), the
  head convs + lazy softmax, and the float path's decode stages. A family
  float path: the bias-in convs (``layers.conv2d_bias_in``), GroupNorm
  with its activation, the depthwise convs, heads + lazy softmax and the
  decode stages. On a family path ``other`` is the rest of the forward
  (the extras' ReLU / ReLU6, max-pool, copies): the whole forward's time
  less its timed parts;
* ``run_scores_ms``: the whole ``InferenceModel.run_scores`` per batch;
* ``profile``: a ``torch.profiler`` window over a few chained batches:
  the same batches timed with CUDA events, untraced
  (``event_ms_per_batch``), and by the host's clock in the window
  (``window_wall_ms_per_batch``), device busy time (a sum of kernel
  times) per batch, the kernels with the most device time, and
  ``span_ms_per_batch``: the device busy ms of the operations launched
  inside each of the program's ``ssd.*`` spans
  (``utils/profiling.span_device_ms``), such as the int8 path's
  ``ssd.int8.conv`` (one a conv, the fused kernel). The
  device's idle share is the benchmark's (``h100bench/``,
  ``idle_share.*``).

With ``--train``: the vgg512 bf16 SGD train step
(``parallel/train_step.make_train_step``) at ``--batch`` (default 32) on
one batch of uint8 images with 1-8 gt boxes each, weights from the seed.
``stages_ms`` is each part of the step in the profiled window, the
device busy ms a step of the operations launched inside its span:
targets (``ssd.step.targets``, ``encode_targets_batch``), the training
forward (``.forward``), loss + hard-negative mining + L2 (``.loss``),
the backward (``.backward``, ``torch.autograd.grad``), the optimizer
update (``.optimizer``) and the detect (``.detect``, softmax +
``decode_detections``, NMS the kernel); ``step_ms`` is the whole step,
and ``profile`` a window over 3 chained steps. The train configuration
is ``chip_smoke.train_config()``'s.

With ``--qat mobilenet320|vgg512``: the QAT train step
(``models/qat.make_qat_train_step``) of ``chip_smoke.py``'s phase 11, the
shipped bundle's dequantized weights in float32, the activation grid
calibrated on 8 augmented images, at ``--batch`` (default 32 / 8) on a
batch augmented on the card (``data/device_augment.py``). ``stages_ms``
as with ``--train`` (the forward is the fake-quant one) plus
``augment`` (timed alone with CUDA events); ``augment_stages_ms``
splits the augmentation into its draws, the photometric distortion, the
geometry (sampler, remap, the positive fallback's IoU) and the window
resampling.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _stages(model, images):
    """``{stage: ms}`` for each layer of the path, in path order: the
    functions ``run_scores`` calls, each timed alone on its inputs."""
    from ssd_tensorflow_tpu_torch.models import ssd_vgg, vgg16
    from ssd_tensorflow_tpu_torch.ops import postprocess, stem_cuda
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms

    p, cfg, det = model.params, model.config, model.detection
    out = {}

    def timed(name, fn):
        out[name] = cuda_event_ms(fn)
        return fn()

    if cfg.pallas_stem_variant == "uint8":
        pool1 = timed("uint8_stem_kernel",
                      lambda: vgg16.conv1_block_uint8(p, images, cfg.mean_bgr))
    else:
        c1 = timed("preprocess_conv1_1",
                   lambda: stem_cuda.conv1_1_unbiased(p, ssd_vgg.preprocess(images, cfg)))
        pool1 = timed("stem_kernel", lambda: stem_cuda.fused_stem(
            c1, p["conv1_1"]["b"], p["conv1_2"]["w"], p["conv1_2"]["b"]))
    conv4_3, x7 = timed("trunk_conv2_to_conv7",
                        lambda: vgg16.apply_backbone(p, pool1, cfg.a_trous, from_pool1=True))
    maps = timed("l2norm_extras", lambda: ssd_vgg._extra_maps(p, conv4_3, x7, cfg))
    conf, cls, locs = timed("heads_lazy_softmax", lambda: ssd_vgg.reduce_head_maps(
        ssd_vgg._head_maps(p, maps, cfg), cfg))
    boxes, conf_top, cls_top, valid = timed("topk_decode_clamp", lambda: (
        postprocess._candidates_from_scores(conf, cls, locs, model.anchors, det)))
    keep = timed("class_shift_nms_kernel", lambda: postprocess._keep(boxes, cls_top, valid, det))
    timed("compaction", lambda: postprocess._finalize(boxes, conf_top, cls_top, keep, det))
    return out


def _int8_stages(model, images):
    """``{stage: ms}`` of the int8 path: every ``_qconv``, and the pools and
    the L2-norm (VGG) or the GroupNorms and depthwise convs (families), of
    one forward recorded with its inputs, each step then timed alone (see
    the module doc; conv12_1's pad of a 2 x 2 map is left out)."""
    import contextlib

    import torch
    from unittest import mock

    from ssd_tensorflow_tpu_torch.models import quantized, ssd_vgg
    from ssd_tensorflow_tpu_torch.ops import int8_conv as ic
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms

    convs, glue, family_calls = [], [], []
    family = model.config.preset.backbone != "vgg"
    heads_of = {id(layer) for name, layer in model.params.items() if name.startswith("classifier")}

    def rec_qconv(layer, x, stride=1, padding="SAME", dilation=1, relu=True):
        convs.append((layer, x, stride, padding, dilation, relu))
        return real_qconv(layer, x, stride, padding, dilation, relu)

    def rec(fn):
        def wrapper(*a, **k):
            glue.append((fn, a, k))
            return fn(*a, **k)
        return wrapper

    real_qconv = quantized._qconv
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(quantized, "_qconv", rec_qconv))
        if family:
            for patch in _family_patches(family_calls, int8=True):
                stack.enter_context(patch)
        else:
            stack.enter_context(mock.patch.object(quantized, "max_pool", rec(quantized.max_pool)))
            stack.enter_context(mock.patch.object(quantized, "l2_normalize_scale",
                                                  rec(quantized.l2_normalize_scale)))
        maps = quantized._feature_maps_q(model.params, images, model.config)
        quantized._head_maps(model.params, maps)
    cfg = model.config
    out = {"preprocess": cuda_event_ms(lambda: ssd_vgg.preprocess(images, cfg).to(torch.bfloat16))}
    for key in ("int8_conv", "heads_lazy_softmax"):
        out[key] = 0.0
    heads = []
    for layer, x, stride, padding, dilation, relu in convs:
        conv = lambda: ic.int8_qconv(x, layer, stride, padding, dilation, relu)  # noqa: E731
        ms = cuda_event_ms(conv)
        if id(layer) not in heads_of:
            out["int8_conv"] += ms
        else:
            heads.append(conv().float())
            out["heads_lazy_softmax"] += ms
    out["heads_lazy_softmax"] += cuda_event_ms(lambda: ssd_vgg.reduce_head_maps(heads, cfg))
    if family:
        _timed_calls(family_calls, out)
        forward = cuda_event_ms(lambda: quantized._forward_scores(model.params, images, cfg))
        out["other"] = max(0.0, forward - sum(out.values()))
    else:
        out["pools_l2norm"] = sum(cuda_event_ms(lambda f=f, a=a, k=k: f(*a, **k))
                                  for f, a, k in glue)
    conf, cls, locs = ssd_vgg.reduce_head_maps(heads, cfg)
    del maps, heads, convs, glue, family_calls
    _decode_stages(model, conf, cls, locs, out)
    return out


def _recorder(calls, kind, fn):
    def wrapper(*a, **k):
        calls.append((kind, fn, a, k))
        return fn(*a, **k)
    return wrapper


def _family_patches(calls, int8: bool):
    """Patches that record, in ``calls``, a family forward's GroupNorms,
    depthwise convs and (float path) bias-in convs with their inputs."""
    from unittest import mock

    from ssd_tensorflow_tpu_torch.models import layers, mobilenet, quantized, resnet, ssd_vgg

    gn = _recorder(calls, "group_norm", resnet.norm_act)
    patches = [mock.patch.object(resnet, "norm_act", gn),
               mock.patch.object(mobilenet, "norm_act", gn)]
    if int8:
        patches.append(mock.patch.object(quantized, "depthwise_conv2d", _recorder(
            calls, "depthwise", quantized.depthwise_conv2d)))
    else:
        patches += [mock.patch.object(layers, "depthwise_conv2d", _recorder(
                        calls, "depthwise", layers.depthwise_conv2d)),
                    mock.patch.object(layers, "conv2d_bias_in", _recorder(
                        calls, "bias_in_convs", layers.conv2d_bias_in)),
                    mock.patch.object(ssd_vgg, "conv2d_bias_in", _recorder(
                        calls, "heads_lazy_softmax", layers.conv2d_bias_in))]
    return patches


def _timed_calls(calls, out):
    """Add each recorded call's CUDA-event time to its kind's stage."""
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms

    for kind, fn, a, k in calls:
        out[kind] = out.get(kind, 0.0) + cuda_event_ms(lambda: fn(*a, **k))


def _decode_stages(model, conf, cls, locs, out):
    from ssd_tensorflow_tpu_torch.ops import postprocess
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms

    det = model.detection
    boxes, conf_top, cls_top, valid = postprocess._candidates_from_scores(
        conf, cls, locs, model.anchors, det)
    out["topk_decode_clamp"] = cuda_event_ms(
        lambda: postprocess._candidates_from_scores(conf, cls, locs, model.anchors, det))
    keep = postprocess._keep(boxes, cls_top, valid, det)
    out["class_shift_nms_kernel"] = cuda_event_ms(
        lambda: postprocess._keep(boxes, cls_top, valid, det))
    out["compaction"] = cuda_event_ms(
        lambda: postprocess._finalize(boxes, conf_top, cls_top, keep, det))


def _family_float_stages(model, images):
    """``{stage: ms}`` of a family's float path (see the module doc)."""
    import contextlib

    from ssd_tensorflow_tpu_torch.models import ssd_vgg
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms

    cfg, calls = model.config, []
    with contextlib.ExitStack() as stack:
        for patch in _family_patches(calls, int8=False):
            stack.enter_context(patch)
        maps = ssd_vgg._feature_maps(model.params, images, cfg)
        heads = ssd_vgg._head_maps(model.params, maps, cfg)
    out = {"preprocess": cuda_event_ms(lambda: ssd_vgg.preprocess(images, cfg))}
    _timed_calls(calls, out)
    out["heads_lazy_softmax"] += cuda_event_ms(lambda: ssd_vgg.reduce_head_maps(heads, cfg))
    forward = cuda_event_ms(lambda: ssd_vgg.apply_scores(model.params, images, cfg))
    out["other"] = max(0.0, forward - sum(out.values()))
    _decode_stages(model, *ssd_vgg.reduce_head_maps(heads, cfg), out)
    return out


def _profile(run, iters=3):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms, device_kernels
    from ssd_tensorflow_tpu_torch.utils.profiling import profiler_events, span_device_ms

    event_ms = cuda_event_ms(run, iters=iters, warmup=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof, iters)
    busy = sum(k[1] for k in kernels)
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    spans = span_device_ms(profiler_events(prof))
    return {
        "event_ms_per_batch": event_ms,
        "window_wall_ms_per_batch": wall_ms / iters,
        "device_busy_ms_per_batch": busy,
        "span_ms_per_batch": {name: ms / iters for name, ms in sorted(spans.items())},
        "top_kernels": [{"name": n[:120], "ms_per_batch": t, "launches_per_batch": c}
                        for n, t, c in kernels[:25]],
        "kernel_launches_per_batch": sum(k[2] for k in kernels),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=None,
                    help="batch size (default 64, or 32 with --train)")
    ap.add_argument("--train", action="store_true", help="profile the vgg512 bf16 train step")
    ap.add_argument("--qat", choices=("mobilenet320", "vgg512"), default=None,
                    help="profile this preset's QAT train step on augmented batches")
    ap.add_argument("--stem-variant", choices=("dma", "uint8"), default="dma")
    ap.add_argument("--preset", choices=("vgg512", "resnet320", "mobilenet320"), default="vgg512",
                    help="the float model's preset (without --bundle)")
    ap.add_argument("--bundle", default=None,
                    help="run this model bundle (an int8 one takes the int8 path)")
    ap.add_argument("--out", default="runs/torch_profile.json")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_profile: needs a GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    if args.qat:
        result = _qat_main(args.qat, args.seed, args.batch)
    elif args.train:
        result = _train_main(args.seed, args.batch or 32)
    else:
        result = _inference_main(args, args.batch or 64)
    result = {"card": smi.splitlines()[0], "torch": torch.__version__, **result}
    text = json.dumps(result, indent=1)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(text + "\n")
    print(text)
    return 0


def _train_main(seed: int, batch_size: int) -> dict:
    import numpy as np
    import torch

    from ssd_tensorflow_tpu_torch.models import ssd_vgg
    from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
    from ssd_tensorflow_tpu_torch.parallel import train_step
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms
    from chip_smoke import train_batch, train_config

    cfg = train_config()
    anchors = anchors_for_preset(cfg.model.preset)
    data = train_batch(np.random.default_rng(seed), batch_size, cfg.model.preset.image_size.h,
                       cfg.model.num_classes)
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    state = train_step.make_train_state(ssd_vgg.init_params(cfg.model, seed), cfg)
    step = train_step.make_train_step(cfg, anchors)
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_event_ms(lambda: step(state, batch), iters=5, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = _profile(lambda: step(state, batch))
    stages = _step_parts(prof)
    return {"preset": cfg.model.preset_name, "path": "train", "dtype": cfg.model.compute_dtype,
            "batch": batch_size, "stages_ms": stages, "stages_sum_ms": sum(stages.values()),
            "step_ms": step_ms, "images_per_s": batch_size / step_ms * 1e3,
            "peak_mem_gib": peak, "profile": prof}


def _step_parts(prof) -> dict:
    """``{part: ms}`` of the train step's ``ssd.step.*`` spans in a
    :func:`_profile` window, device busy ms a step."""
    return {name.removeprefix("ssd.step."): ms for name, ms in prof["span_ms_per_batch"].items()
            if name.startswith("ssd.step.")}


def _augment_stages(acfg, generator, batch, anchors):
    """``{stage: ms}`` of one augmentation of ``batch``, each part timed
    alone on the inputs the chain gives it."""
    from ssd_tensorflow_tpu_torch.data import device_augment as da
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms

    out = {}

    def timed(name, fn):
        out[name] = cuda_event_ms(fn, iters=3, warmup=1)
        return fn()

    draws = timed("draws", lambda: da.draw_augment(generator, batch["images"].shape[0], acfg))
    img = timed("photometric", lambda: da._photometric(draws, batch["images"].float(), acfg))
    window, flip, *_ = timed("geometry", lambda: da.augment_geometry(draws, batch, anchors, acfg))
    timed("resample", lambda: da.resample_window(img, window, flip, acfg.out_h, acfg.out_w,
                                                 acfg.mean_bgr))
    return out


def _qat_main(name: str, seed: int, batch_size) -> dict:
    import numpy as np
    import torch

    from ssd_tensorflow_tpu_torch.data import device_augment as da
    from ssd_tensorflow_tpu_torch.models import qat
    from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
    from ssd_tensorflow_tpu_torch.ops.postprocess import DetectionConfig
    from ssd_tensorflow_tpu_torch.parallel import train_step
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms
    from chip_smoke import QAT_RUNS, dequantized_params, train_batch

    fname, default_batch, _ = QAT_RUNS[name]
    batch_size = batch_size or default_batch
    params, bundle_cfg = dequantized_params(Path(__file__).resolve().parent.parent / fname)
    cfg = train_step.TrainConfig(model=qat.qat_model_config(bundle_cfg),
                                 detect=DetectionConfig(confidence_threshold=0.01))
    preset = cfg.model.preset
    anchors = anchors_for_preset(preset)
    on_card = torch.from_numpy(anchors).cuda()
    raw = {k: torch.from_numpy(v).cuda() for k, v in train_batch(
        np.random.default_rng(seed), batch_size, preset.image_size.h,
        cfg.model.num_classes).items()}
    acfg = da.augment_config_for(preset)
    augment = da.make_augment_fn(acfg, anchors)
    generator = torch.Generator("cuda").manual_seed(seed)
    batch = augment(generator, raw)
    state = train_step.make_train_state(params, cfg)
    act, _ = qat.qat_scales(state.params, cfg.model, None, batch["images"][:8])
    step = qat.make_qat_train_step(cfg, anchors, act)
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_event_ms(lambda: step(state, batch), iters=5, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = _profile(lambda: step(state, augment(generator, raw)))
    stages = {"augment": cuda_event_ms(lambda: augment(generator, raw), iters=3, warmup=1),
              **_step_parts(prof)}
    return {"preset": name, "path": "qat", "dtype": cfg.model.compute_dtype,
            "batch": batch_size, "stages_ms": stages, "stages_sum_ms": sum(stages.values()),
            "augment_stages_ms": _augment_stages(acfg, generator, raw, on_card),
            "step_ms": step_ms, "images_per_s": batch_size / step_ms * 1e3,
            "peak_mem_gib": peak, "profile": prof}


def _inference_main(args, batch_size: int) -> dict:
    import numpy as np
    import torch

    from ssd_tensorflow_tpu_torch.inference import InferenceModel
    from ssd_tensorflow_tpu_torch.models import ssd_vgg
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms

    if args.bundle:
        model = InferenceModel.from_bundle(args.bundle)
        cfg = model.config
    else:
        cfg = ssd_vgg.ModelConfig(preset_name=args.preset,
                                  num_classes=80 if args.preset == "resnet320" else 20,
                                  compute_dtype="bfloat16")
        overrides = {"pallas_stem_variant": args.stem_variant} if args.preset == "vgg512" else None
        model = InferenceModel(ssd_vgg.init_params(cfg, seed=args.seed), cfg, overrides=overrides)
    int8 = model.act_scales is not None
    family = cfg.preset.backbone != "vgg"
    size = cfg.preset.image_size
    rng = np.random.default_rng(args.seed)
    images = torch.from_numpy(
        rng.integers(0, 256, (batch_size, size.h, size.w, 3), dtype=np.uint8)).cuda()
    with torch.inference_mode():
        stages = (_int8_stages if int8 else _family_float_stages if family else _stages)(
            model, images)
        run_ms = cuda_event_ms(lambda: model.run_scores(images))
        prof = _profile(lambda: model.run_scores(images))
    return {
        "preset": cfg.preset_name,
        "path": "int8" if int8 else cfg.compute_dtype, "bundle": args.bundle,
        "stem_variant": None if int8 or family else args.stem_variant, "batch": batch_size,
        "stages_ms": stages,
        "stages_sum_ms": sum(stages.values()), "run_scores_ms": run_ms,
        "images_per_s": batch_size / run_ms * 1e3, "profile": prof,
    }


if __name__ == "__main__":
    sys.exit(main())
