#!/usr/bin/env python3
"""Per-layer cost and rounding of the conv + bias + ReLU routes, on one GPU.

    python3 tools/torch_conv_epilogue.py [--seed 0] [--batch 64] [--out runs/torch_conv_epilogue.json]

Records every conv + bias + ReLU call of the vgg512 bf16 forward (as
``chip_smoke.py``'s conv_epilogue phase does) at ``--batch``, gives each
a float32 bias from the seed, and prints one JSON line per layer:

* ``fused_ms``: cuDNN's fused conv + bias + ReLU
  (``torch.cudnn_convolution_relu``, float32 bias), the port's route;
* ``unfused_ms``: bf16 ``F.conv2d`` with a bf16 bias + ReLU, the route
  before it;
* ``fused_equal`` / ``unfused_equal``: the share of outputs equal to the
  one-rounding reference ``bf16(relu(conv_f32 + b))`` (TF32 off);
* ``fused_bf16_bias_equal``: the same share when the fused op is handed
  the bias in bf16 (why the port passes it in float32).

Times are CUDA events over chained calls. The last line sums them.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--out", default="runs/torch_conv_epilogue.json")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_conv_epilogue: needs a GPU", file=sys.stderr)
        return 2
    from chip_smoke import conv_calls, one_rounding_reference, unfused
    from ssd_tensorflow_tpu_torch.inference import InferenceModel
    from ssd_tensorflow_tpu_torch.models import layers, ssd_vgg
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = ssd_vgg.ModelConfig(preset_name="vgg512", num_classes=20)
    model = InferenceModel(ssd_vgg.init_params(cfg, seed=args.seed), cfg)
    size = cfg.preset.image_size
    images = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, 256, (args.batch, size.h, size.w, 3), dtype=np.uint8)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = []
    with torch.inference_mode():
        for call in conv_calls(model, images):
            if call["kind"] != "conv_relu":
                continue
            bias = torch.randn(call["w"].shape[0], generator=gen, device="cuda") * 0.5
            ref = one_rounding_reference(call, bias)
            pad = layers._same_input(call["x"], call["w"], call["stride"], call["padding"],
                                     call["dilation"])

            def fused(b=bias):
                return layers.conv_relu({"w": call["w"], "b": b}, call["x"], call["stride"],
                                        call["padding"], call["dilation"])

            bf16_bias = torch.cudnn_convolution_relu(
                pad[0], call["w"], bias.to(torch.bfloat16), [call["stride"]] * 2, list(pad[1]),
                [call["dilation"]] * 2, 1).permute(0, 2, 3, 1)
            row = {"x": list(call["x"].shape), "w": list(call["w"].shape),
                   "stride": call["stride"], "padding": call["padding"],
                   "dilation": call["dilation"],
                   "fused_ms": cuda_event_ms(fused, iters=10),
                   "unfused_ms": cuda_event_ms(lambda: unfused(call, bias), iters=10),
                   "fused_equal": float((fused() == ref).float().mean()),
                   "unfused_equal": float((unfused(call, bias) == ref).float().mean()),
                   "fused_bf16_bias_equal": float((bf16_bias == ref).float().mean())}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del ref, bf16_bias
    total = {"card": card, "batch": args.batch, "layers": len(rows),
             "fused_ms_sum": sum(r["fused_ms"] for r in rows),
             "unfused_ms_sum": sum(r["unfused_ms"] for r in rows)}
    print(json.dumps(total), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows + [total]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
