#!/usr/bin/env python3
"""Time the stem probes' CUDA kernels and the port's stems on one GPU.

    python3 tools/torch_stem_probe.py [--seed 0] [--out runs/torch_stem_probe.json]

The counterpart of ``tools/stem_kernel_probe.py`` and
``tools/stem_uint8_probe.py`` (TPU tools of the JAX package), on the
port's kernels (``ssd_tensorflow_tpu_torch/ops/stem_probe.py``,
``ops/stem_cuda.py``). Prints one JSON line per row and writes them all
to ``--out``:

1. ``lane_unflatten_sum``: ``(36, 1536)`` bf16 -> ``(36, 256)``, the
   kernel against its plain version (bit-exact) and its time;
2. each stem-probe variant (copy, conv1_1, conv1_1 + store, 1 / 3 / 9 taps,
   aligned columns) at the TPU probe's shape: a1 ``(64, 16, 34, 256, 64)``
   bf16, w1 ``(64, 128)``, w2 ``(3, 3, 128, 128)``;
3. the stems at vgg512 batch 64 from the raw uint8 image: the library
   stem (preprocess + cuDNN conv1_1 + ReLU + conv1_2 + ReLU + max-pool in
   bf16), the whole-stem uint8 kernel and the split stem.

Times: ``ms`` is device time from a ``torch.profiler`` window, ``event_ms``
CUDA events around chained calls (it includes host launch cost). Needs
a GPU; imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _times(fn, kernel_name: str, iters: int = 5):
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms, kernel_device_ms

    return {"ms": kernel_device_ms(fn, kernel_name, iters=iters),
            "event_ms": cuda_event_ms(fn, iters=iters)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/torch_stem_probe.json")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_stem_probe: needs a GPU", file=sys.stderr)
        return 2
    from chip_smoke import MEAN_BGR, library_stem
    from ssd_tensorflow_tpu_torch.models import ssd_vgg
    from ssd_tensorflow_tpu_torch.ops import stem_cuda, stem_probe

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    rows = []

    def emit(row):
        row["card"] = card
        rows.append(row)
        print(json.dumps(row), flush=True)

    with torch.inference_mode():
        x = torch.randn((36, 1536), device=device).to(torch.bfloat16)
        got = stem_probe.lane_unflatten_sum(x)
        emit({"row": "[1] lane_unflatten_sum", "shape": [36, 1536],
              "bit_exact": bool(torch.equal(got, stem_probe.lane_unflatten_sum_plain(x))),
              **_times(lambda: stem_probe.lane_unflatten_sum(x), "lane_unflatten", iters=50)})

        a1, w1, w2 = stem_probe.probe_inputs(args.seed, device)
        for variant in stem_probe.PROBE_VARIANTS:
            fn = (lambda v=variant: stem_probe.stem_probe(a1, w1, w2, v))
            want = stem_probe.stem_probe_plain(a1, w1, w2, variant)
            err = float((fn().float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            del want
            emit({"row": f"[2] stem_probe {variant}", "shape": list(a1.shape),
                  "max_abs_err": err, "max_ref": scale, **_times(fn, "probe_")})
        del a1

        cfg = ssd_vgg.ModelConfig(preset_name="vgg512", num_classes=20)
        params = {k: {n: v.to(device) for n, v in p.items()}
                  for k, p in ssd_vgg.init_params(cfg, seed=args.seed).items()
                  if k in ("conv1_1", "conv1_2")}
        rng = np.random.default_rng(args.seed)
        images = torch.from_numpy(rng.integers(0, 256, (64, 512, 512, 3), dtype=np.uint8)).to(device)
        for name, fn in (
            ("library stem (cuDNN, bf16)", lambda: library_stem(params, images)),
            ("fused_stem_uint8", lambda: stem_cuda.fused_stem_uint8(params, images, MEAN_BGR)),
            ("fused_stem_pallas_dma (split)",
             lambda: stem_cuda.fused_stem_pallas_dma(params, images, MEAN_BGR)),
        ):
            emit({"row": f"[3] {name}", "shape": list(images.shape), **_times(fn, "", iters=5)})
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
