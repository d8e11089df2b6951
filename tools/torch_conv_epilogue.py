#!/usr/bin/env python3
"""Per-layer cost and rounding of the conv + bias (+ ReLU) routes, on one GPU.

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

Each of the seven multibox head convs (no ReLU) gets a line too, with the
time and the equal share of three routes: ``bias_in`` (the port's
``layers.conv2d_bias_in``: the bias as two input channels), ``relu_halves``
(cuDNN's fused op on ``[w, -w]`` with bias ``[b, -b]``, then the
difference of the halves) and ``unfused`` (bf16 conv + bf16 bias pass, the
route before). ``*_equal`` is the share equal to the float32 reference,
``*_equal_exact`` the share equal to ``bf16(conv_f64 + b)``, the one
rounding of the exact sum; ``reference_equal_exact`` says how often the
float32 reference itself lands on it.

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
    def head_row(call, bias, ref):
        """One multibox head conv (no ReLU): the port's route, the route it
        replaced and the other candidate, each timed and held to ``ref``."""
        x, w = call["x"], call["w"]
        wb = layers.widen_bias(w, bias)
        w2 = torch.cat([w, -w]).contiguous(memory_format=torch.channels_last)
        b2 = torch.cat([bias, -bias])
        xn = x.permute(0, 3, 1, 2)
        cout = w.shape[0]

        def bias_in():
            return layers.conv2d_bias_in(x, wb)

        def relu_halves():  # relu(y) - relu(-y) = y, each half rounded once
            y = torch.cudnn_convolution_relu(xn, w2, b2, [1, 1], [1, 1], [1, 1], 1)
            return (y[:, :cout] - y[:, cout:]).permute(0, 2, 3, 1)

        # the nine taps as GEMMs over the zero-padded map read flat (a tap is
        # a row offset), accumulated in a float32 matrix that starts as b
        n, h, wd, cin = x.shape
        m = n * (h + 2) * (wd + 2)
        cpad = -(-cout // 8) * 8
        wt = torch.zeros((9, cin, cpad), dtype=w.dtype, device=w.device)
        wt[:, :, :cout] = w.permute(2, 3, 1, 0).reshape(9, cin, cout)
        bpad = torch.zeros(cpad, device=w.device)
        bpad[:cout] = bias

        def tap_gemms():
            flat = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1)).reshape(m, cin)
            flat = torch.nn.functional.pad(flat, (0, 0, 0, 2 * (wd + 2) + 2))
            acc = bpad.expand(m, cpad).contiguous()
            for tap in range(9):
                off = (tap // 3) * (wd + 2) + tap % 3
                acc = torch.addmm(acc, flat[off:off + m], wt[tap], out_dtype=torch.float32)
            return acc.to(torch.bfloat16).view(n, h + 2, wd + 2, cpad)[:, :h, :wd, :cout]

        routes = {"bias_in": bias_in, "relu_halves": relu_halves, "tap_gemms": tap_gemms,
                  "unfused": lambda: unfused(call, bias)}
        # the same sum taken in float64: what one rounding of the exact value gives
        exact = (torch.nn.functional.conv2d(xn.double(), w.double(), bias.double(), 1, 1)
                 .to(torch.bfloat16).permute(0, 2, 3, 1))
        row = {"kind": "head", "x": list(x.shape), "w": list(w.shape),
               "reference_equal_exact": float((ref == exact).float().mean())}
        for name, fn in routes.items():
            row[f"{name}_ms"] = cuda_event_ms(fn, iters=10)
            row[f"{name}_equal"] = float((fn() == ref).float().mean())
            row[f"{name}_equal_exact"] = float((fn() == exact).float().mean())
        return row

    rows, head_rows = [], []
    with torch.inference_mode():
        for call in conv_calls(model, images):
            bias = torch.randn(call["w"].shape[0], generator=gen, device="cuda") * 0.5
            ref = one_rounding_reference(call, bias)
            if call["kind"] == "head":
                head_rows.append(head_row(call, bias, ref))
                print(json.dumps(head_rows[-1]), flush=True)
                continue
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
             "unfused_ms_sum": sum(r["unfused_ms"] for r in rows),
             "heads": len(head_rows),
             **{f"heads_{k}_ms_sum": sum(r[f"{k}_ms"] for r in head_rows)
                for k in ("bias_in", "relu_halves", "tap_gemms", "unfused")},
             **{f"heads_{k}_equal_min": min(r[f"{k}_equal"] for r in head_rows)
                for k in ("bias_in", "relu_halves", "tap_gemms", "unfused")},
             **{f"heads_{k}_equal_exact_min": min(r[f"{k}_equal_exact"] for r in head_rows)
                for k in ("bias_in", "relu_halves", "tap_gemms", "unfused")},
             "heads_reference_equal_exact_min": min(r["reference_equal_exact"]
                                                    for r in head_rows)}
    print(json.dumps(total), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows + head_rows + [total]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
