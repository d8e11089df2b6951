#!/usr/bin/env python3
"""Time the greedy-NMS kernel, every stem-probe variant, the lane sum and
the fused int8 conv of one or more checkouts in turns, on one NVIDIA GPU,
to compare a change with its parent within one run.

    python3 tools/torch_kernel_bench.py [--roots . _parent] [--rounds 4]
        [--batch 64] [--candidates 200] [--probe-shape 64 16 256]
        [--only nms probes lane qconv] [--out runs/kernel_bench.json]

Each root is a checkout of this repository (``.`` is the one the script
lives in; unpack another commit with ``git archive <commit> | tar -x -C
_parent``). Roots take turns in the order a, b, b, a, a, b, ... so that
drift of the card's clocks falls on both; every turn is a fresh process
that builds (or reuses) that checkout's kernels, checks each kernel
against its plain version (NMS and the probe's copy bit for bit, the
other probe variants within one bf16 step of the largest output) and
reports the kernel's device time from a profiler window and the
CUDA-event time per call. The lane sum (``ops/stem_probe.lane_unflatten_sum``
at (36, 1536), bit for bit) has a "launch_floor" row beside it where the
checkout has ``stem_probe.launch_floor``: an empty kernel on the same
grid, launched in turns with the lane sum inside one profiler window, the
practical bound of launch-sized work. ``qconv`` times
``ops/int8_conv.int8_qconv`` (``csrc/int8_conv.cu``) at six vgg512
convs of ``--batch`` images (:data:`QCONV_SHAPES`) beside their bound
(:func:`conv_bound_ms`) and the CUDA-event ms of the card chain
(``int8_qconv_plain``: quantize, im2col + ``_int_mm``, requant) on the
same inputs, after checking the two equal bit for bit; a checkout without
the kernel reports the chain alone. The last line is one JSON object
with the card, and per root and kernel the median, minimum and maximum
device ms.

``--one ROOT`` runs a single turn (what the turns call); ``--log``
prints nvcc's ptxas report of the two sources with it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def nms_inputs(rng, b: int, d: int, device):
    """Score-sorted candidates with overlap clusters, class-shifted canvas
    corners ``(B, D, 4)`` float32 and the ``(B, D)`` bool valid mask."""
    import numpy as np
    import torch

    w, h = rng.uniform(0.05, 0.5, (2, b, d))
    boxes = np.stack([rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2), w, h], -1)
    half = d // 2
    boxes[:, :half] = np.clip(boxes[:, np.arange(half) % 8] + rng.normal(0, 0.01, (b, half, 4)),
                              0.02, 0.98)
    cx, cy, bw, bh = (boxes[..., k] * 1000 for k in range(4))
    corners = np.trunc(np.stack([cx - bw / 2, cx + bw / 2, cy - bh / 2, cy + bh / 2], -1))
    corners = corners + rng.integers(0, 21, (b, d))[..., None] * 4096.0
    valid = np.sort(rng.uniform(0, 1, (b, d)), axis=1)[:, ::-1] > 0.3
    return (torch.tensor(corners, dtype=torch.float32, device=device),
            torch.tensor(valid.copy(), device=device))


def lane_rows(stem_probe, seed: int, device, iters: int = 200) -> dict:
    """The lane sum at (36, 1536), checked bit for bit, and the launch
    floor of its grid: device ms of both from one profiler window in which
    they take turns, and the CUDA-event ms of each alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms, device_kernels, per_call_ms

    x = torch.randn((36, 1536), generator=torch.Generator(device=device).manual_seed(seed),
                    device=device).to(torch.bfloat16)
    if not torch.equal(stem_probe.lane_unflatten_sum(x), stem_probe.lane_unflatten_sum_plain(x)):
        raise SystemExit("lane_unflatten_sum differs from its plain version")
    calls = {"lane_unflatten_sum": (lambda: stem_probe.lane_unflatten_sum(x), "lane_unflatten")}
    if hasattr(stem_probe, "launch_floor"):
        calls["launch_floor"] = (lambda: stem_probe.launch_floor(x), "launch_floor")
    for _ in range(3):
        for fn, _ in calls.values():
            fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            for fn, _ in calls.values():
                fn()
        torch.cuda.synchronize()
    kernels = device_kernels(prof, iters)
    out = {}
    for name, (fn, kernel) in calls.items():
        hits = [k for k in kernels if kernel in k[0]]
        if not hits:
            raise SystemExit(f"the profiler recorded no device time for {kernel!r}")
        out[name] = {"shape": list(x.shape), "ms": per_call_ms(hits),
                     "event_ms": cuda_event_ms(fn, iters=iters)}
    return out


#: vgg512 int8 convs the ``qconv`` rows time: name -> (H = W, cin, k, cout, dilation, relu)
QCONV_SHAPES = {"conv1_1": (512, 3, 3, 64, 1, True), "conv1_2": (512, 64, 3, 64, 1, True),
                "conv3_2": (128, 256, 3, 256, 1, True), "conv4_2": (64, 512, 3, 512, 1, True),
                "mod_conv6": (32, 512, 3, 1024, 6, True),
                "classifier1": (32, 1024, 3, 150, 1, False)}


def conv_bound_ms(b: int, hw: int, cin: int, k: int, cout: int) -> float:
    """The least time of a stride-1 SAME int8 conv on an H100 SXM: the
    larger of its operations at 1,979 TOP/s and its bytes at 3.35 TB/s (the
    bf16 input read once, the int8 filter, the bf16 output written once),
    as ``h100bench/benchlib/counts.py`` counts them."""
    ops = 2.0 * b * hw * hw * cout * k * k * cin
    nbytes = b * hw * hw * cin * 2 + k * k * cin * cout + b * hw * hw * cout * 2
    return max(ops / 1979e12, nbytes / 3.35e12) * 1e3


def qconv_rows(int8_conv, batch: int, seed: int, device) -> dict:
    """The ``qconv`` rows: each shape's kernel and chain, on seeded random
    inputs and scales."""
    import torch

    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms, kernel_device_ms

    rows = {}
    if not hasattr(int8_conv, "int8_qconv"):  # a checkout from before the kernel
        return rows
    for name, (hw, cin, k, cout, dil, relu) in QCONV_SHAPES.items():
        g = torch.Generator(device=device).manual_seed(seed + hw * cin + cout)
        wq = torch.randint(-127, 128, (k, k, cin, cout), generator=g, device=device,
                           dtype=torch.int8)
        layer = {"w": int8_conv.stage_int8_weight(wq),
                 "inv": torch.tensor([25.0], device=device),
                 "mult": 1e-6 + 1e-4 * torch.rand(cout, generator=g, device=device),
                 "b": torch.randn(cout, generator=g, device=device)}
        x = (3 * torch.randn((batch, hw, hw, cin), generator=g, device=device)).to(torch.bfloat16)

        chain = lambda: int8_conv.int8_qconv_plain(x, layer, 1, "SAME", dil, relu)  # noqa: E731
        row = {"shape": [batch, hw, hw, cin, k, cout, dil],
               "bound_ms": conv_bound_ms(batch, hw, cin, k, cout),
               "chain_event_ms": cuda_event_ms(chain, iters=3, warmup=1)}
        run = lambda: int8_conv.int8_qconv(x, layer, 1, "SAME", dil, relu)  # noqa: E731
        got, want = run(), chain()
        if not torch.equal(got, want):
            raise SystemExit(f"int8_qconv differs from the chain at {name}: "
                             f"{int((got != want).sum())} of {want.numel()}")
        del got, want
        row["ms"] = kernel_device_ms(run, "qconv_", iters=10)
        row["event_ms"] = cuda_event_ms(run, iters=10)
        row["roofline_pct"] = 100.0 * row["bound_ms"] / row["ms"]
        rows[f"int8_qconv:{name}"] = row
        del x, layer
        torch.cuda.empty_cache()
    return rows


def one_turn(root: Path, args) -> dict:
    sys.path.insert(0, str(root.resolve()))
    import numpy as np
    import torch

    from ssd_tensorflow_tpu_torch.ops import _build, int8_conv, nms_cuda, stem_probe
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms, kernel_device_ms

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_bench: needs a GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    _build.libraries()
    out = {"root": str(root), "device": torch.cuda.get_device_name(0), "kernels": {}}

    with torch.inference_mode():
        if "nms" in args.only:
            corners, valid = nms_inputs(np.random.default_rng(args.seed), args.batch,
                                        args.candidates, device)
            run = lambda: nms_cuda.nms_keep(corners, valid)
            got, want = run(), nms_cuda.nms_keep_plain(corners, valid)
            if not torch.equal(got, want):
                raise SystemExit(f"nms_keep of {root} differs from its plain version on "
                                 f"{int((got != want).sum())} flags")
            out["kernels"]["nms_keep"] = {
                "shape": [args.batch, args.candidates], "kept": int(got.sum()),
                "ms": kernel_device_ms(run, "nms_kernel", iters=200),
                "event_ms": cuda_event_ms(run, iters=200)}
        if "probes" in args.only:
            a1, w1, w2 = stem_probe.probe_inputs(args.seed, device, shape=tuple(args.probe_shape))
            for variant in stem_probe.PROBE_VARIANTS:
                run = lambda v=variant: stem_probe.stem_probe(a1, w1, w2, v)
                got = run().float()
                want = stem_probe.stem_probe_plain(a1, w1, w2, variant).float()
                err, scale = float((got - want).abs().max()), float(want.abs().max())
                tol = 0.0 if variant == "copy" else scale * 2.0 ** -7
                equal = float((got == want).float().mean())
                del got, want
                if not (scale > 0 and err <= tol):
                    raise SystemExit(f"stem_probe({variant}) of {root} differs from its plain "
                                     f"version: max err {err} > {tol}, equal share {equal}")
                out["kernels"][f"stem_probe:{variant}"] = {
                    "shape": list(a1.shape), "max_abs_err": err, "tolerance": tol,
                    "equal_share": equal,
                    "ms": kernel_device_ms(run, "probe_", iters=5),
                    "event_ms": cuda_event_ms(run, iters=5)}
        if "lane" in args.only:
            out["kernels"].update(lane_rows(stem_probe, args.seed, device))
        if "qconv" in args.only:
            out["kernels"].update(qconv_rows(int8_conv, args.batch, args.seed, device))
    if args.log:
        out["ptxas"] = {n: [ln for ln in _build.build_log(n).splitlines()
                            if "registers" in ln or "spill" in ln or "warning" in ln.lower()]
                        for n in ("nms", "stem_probe", "int8_conv")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", default=["."])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--candidates", type=int, default=200)
    ap.add_argument("--probe-shape", type=int, nargs=3, default=[64, 16, 256],
                    metavar=("B", "T", "WP"))
    ap.add_argument("--only", nargs="+", choices=["nms", "probes", "lane", "qconv"],
                    default=["nms", "probes", "lane", "qconv"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--one", default=None, help="run one turn of this root and print it")
    ap.add_argument("--log", action="store_true")
    args = ap.parse_args(argv)
    here = Path(__file__).resolve().parent.parent

    if args.one is not None:
        print(json.dumps(one_turn(Path(args.one), args)), flush=True)
        return 0

    roots = [str((here / r).resolve()) for r in args.roots]
    order = []
    for i in range(args.rounds):
        order += roots if i % 2 == 0 else roots[::-1]
    turns = []
    for root in order:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--one", root,
               "--batch", str(args.batch), "--candidates", str(args.candidates),
               "--probe-shape", *map(str, args.probe_shape), "--only", *args.only,
               "--seed", str(args.seed)]
        if args.log and root not in [t["root"] for t in turns]:
            cmd.append("--log")
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stdout[-4000:], done.stderr[-8000:], sep="\n", file=sys.stderr)
            return done.returncode or 1
        turns.append(json.loads(done.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    summary = {}
    for root in roots:
        mine = [t for t in turns if t["root"] == root]
        for name in mine[0]["kernels"]:
            for key in ("ms", "event_ms", "chain_event_ms"):
                if key not in mine[0]["kernels"][name]:
                    continue
                runs = [t["kernels"][name][key] for t in mine]
                summary.setdefault(root, {}).setdefault(name, {})[key] = {
                    "runs": runs, "median": statistics.median(runs), "min": min(runs),
                    "max": max(runs)}
    result = {"card": smi, "order": order, "summary": summary, "turns": turns}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({"card": smi, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
