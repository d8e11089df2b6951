#!/usr/bin/env python3
"""Time the two conv1 stem kernels of one or more checkouts in turns, on
one NVIDIA GPU, to compare a change with its parent within one run.

    python3 tools/torch_stem_bench.py [--roots . _parent] [--rounds 3]
        [--batch 64] [--size 512] [--out runs/stem_bench.json]

Each root is a checkout of this repository (``.`` is the one the script
lives in; unpack another commit with ``git archive <commit> | tar -x -C
_parent``). Roots take turns in the order a, b, b, a, a, b, ... so that
drift of the card's clocks falls on both; every turn is a fresh process
that builds (or reuses) that checkout's kernels, checks both stems
against their plain versions (one bf16 step of the largest output) and
reports the kernel's device time from a profiler window and the
CUDA-event time per call. The last line is one JSON object with every
turn and, per root and kernel, the mean, minimum and maximum.

``--one ROOT`` runs a single turn (what the turns call); ``--log``
prints nvcc's ptxas report of the stem sources with it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

MEAN_BGR = (104.0, 117.0, 123.0)


def one_turn(root: Path, batch: int, size: int, seed: int, log: bool) -> dict:
    sys.path.insert(0, str(root.resolve()))
    import numpy as np
    import torch

    from ssd_tensorflow_tpu_torch.models import ssd_vgg
    from ssd_tensorflow_tpu_torch.ops import _build, stem_cuda
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms, kernel_device_ms

    if not torch.cuda.is_available():
        raise SystemExit("torch_stem_bench: needs a GPU")
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    _build.libraries()
    cfg = ssd_vgg.ModelConfig(preset_name="vgg512", num_classes=20, compute_dtype="bfloat16")
    full = ssd_vgg.init_params(cfg, seed=seed)
    rng = np.random.default_rng(seed)
    params = {k: {n: v.to(device) for n, v in full[k].items()} for k in ("conv1_1", "conv1_2")}
    for p in params.values():
        p["b"] = torch.tensor(rng.normal(0, 1, 64), dtype=torch.float32, device=device)
    images = torch.from_numpy(rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)).to(device)
    p1, p2 = params["conv1_1"], params["conv1_2"]

    out = {"root": str(root), "batch": batch, "size": size,
           "device": torch.cuda.get_device_name(0)}
    with torch.inference_mode():
        c1 = stem_cuda.conv1_1_unbiased(params, stem_cuda._preprocess(images, MEAN_BGR))
        runs = {
            "fused_stem": (lambda: stem_cuda.fused_stem(c1, p1["b"], p2["w"], p2["b"]),
                           lambda: stem_cuda.fused_stem_plain(c1, p1["b"], p2["w"], p2["b"]),
                           "stem_kernel"),
            "fused_stem_uint8": (lambda: stem_cuda.fused_stem_uint8(params, images, MEAN_BGR),
                                 lambda: stem_cuda.fused_stem_uint8_plain(params, images, MEAN_BGR),
                                 "stem_uint8_kernel"),
        }
        for name, (kernel, plain, kernel_name) in runs.items():
            got, want = kernel().float(), plain().float()
            torch.cuda.synchronize()
            err, scale = float((got - want).abs().max()), float(want.abs().max())
            equal = float((got == want).float().mean())
            del got, want
            if not (scale > 0 and err <= scale * 2.0 ** -7):
                raise SystemExit(f"{name} of {root} differs from its plain version: "
                                 f"max err {err}, max |ref| {scale}, equal share {equal}")
            out[name] = {"ms": kernel_device_ms(kernel, kernel_name, iters=10),
                         "event_ms": cuda_event_ms(kernel, iters=10),
                         "max_abs_err": err, "max_ref": scale, "equal_share": equal}
    if log:
        out["ptxas"] = {n: _build.build_log(n).splitlines() for n in ("stem", "stem_uint8")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", default=["."])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--one", default=None, help="run one turn of this root and print it")
    ap.add_argument("--log", action="store_true")
    args = ap.parse_args(argv)
    here = Path(__file__).resolve().parent.parent

    if args.one is not None:
        print(json.dumps(one_turn(Path(args.one), args.batch, args.size, args.seed, args.log)),
              flush=True)
        return 0

    roots = [str((here / r).resolve()) for r in args.roots]
    order = []
    for i in range(args.rounds):
        order += roots if i % 2 == 0 else roots[::-1]
    turns = []
    for root in order:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--one", root, "--batch",
               str(args.batch), "--size", str(args.size), "--seed", str(args.seed)]
        if args.log and root not in [t["root"] for t in turns]:
            cmd.append("--log")
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stdout[-4000:], done.stderr[-8000:], sep="\n", file=sys.stderr)
            return done.returncode
        turns.append(json.loads(done.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    summary = {}
    for root in roots:
        for name in ("fused_stem", "fused_stem_uint8"):
            ms = [t[name]["ms"] for t in turns if t["root"] == root]
            summary.setdefault(root, {})[name] = {
                "runs": ms, "mean": sum(ms) / len(ms), "min": min(ms), "max": max(ms)}
    result = {"card": smi, "order": order, "summary": summary, "turns": turns}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({"card": smi, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
