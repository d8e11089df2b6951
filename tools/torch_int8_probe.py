#!/usr/bin/env python3
"""The int8 path's library pieces on one NVIDIA GPU.

    python3 tools/torch_int8_probe.py [--bundle assets/vgg512_int8_minivoc.ssdtpu.npz]
                                      [--batch 64] [--seed 0] [--out runs/int8_probe.json]

Prints one JSON object (and writes it to ``--out``):

* ``int_mm_layouts``: which operand layouts ``torch._int_mm`` takes, each
  checked against an exact product (``ops/int8_conv.py`` passes A
  row-major and B column-major);
* ``int_mm_rates``: CUDA-event ms and TOP/s of ``_int_mm`` at the int8
  path's GEMM shapes (conv1_2's 1 GiB chunk, conv4, mod_conv6, a head);
* ``addcmul``: the share of ``torch.addcmul(b, int32 sums, float32)``
  outputs equal to one float32 multiply-add (``models/quantized.requant``
  relies on it) and to two roundings;
* ``l2norm_layouts``: the share of L2-normalized conv4_3 values equal
  between an NHWC tensor and the same values as a permuted NCHW view;
* ``layers``: the bundle's forward on ``--batch`` random uint8 images from
  the seed, every ``int8_conv`` call's card route against its plain route
  on the same input (number of unequal sums, largest |sum|).

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _layouts(device):
    import torch

    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randint(-127, 128, (4096, 576), generator=g, device=device, dtype=torch.int8)
    b = torch.randint(-127, 128, (576, 64), generator=g, device=device, dtype=torch.int8)
    want = (a.double() @ b.double()).to(torch.int32)
    out = {}
    for an, aa in (("a_row", a), ("a_col", a.t().contiguous().t())):
        for bn, bb in (("b_row", b), ("b_col", b.t().contiguous().t())):
            try:
                out[f"{an}/{bn}"] = bool(torch.equal(torch._int_mm(aa, bb), want))
            except RuntimeError as e:
                out[f"{an}/{bn}"] = f"refused: {str(e)[:160]}"
    return out


def _rates(device):
    import torch

    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms

    g = torch.Generator(device=device).manual_seed(1)
    out = {}
    for m, k, n in ((1835008, 576, 64), (262144, 4608, 512), (65536, 4608, 1024),
                    (16384, 9216, 160)):
        a = torch.randint(-127, 128, (m, k), generator=g, device=device, dtype=torch.int8)
        bt = torch.randint(-127, 128, (n, k), generator=g, device=device, dtype=torch.int8)
        c = torch.empty((m, n), dtype=torch.int32, device=device)
        ms = cuda_event_ms(lambda: torch._int_mm(a, bt.t(), out=c), iters=10)
        out[f"{m}x{k}x{n}"] = {"ms": ms, "tops": 2.0 * m * k * n / ms / 1e9}
    return out


def _addcmul(device):
    """Share of ``addcmul(b, int32 sums, m)`` outputs equal to one float32
    multiply-add and to two roundings."""
    import torch

    g = torch.Generator(device=device).manual_seed(2)
    y = torch.randint(-2**22, 2**22, (4, 32, 32, 96), generator=g, device=device,
                      dtype=torch.int32)
    m = torch.rand(96, generator=g, device=device) * 1e-2
    b = torch.randn(96, generator=g, device=device)
    got = torch.addcmul(b, y, m)
    fma = (y.double() * m.double() + b.double()).float()
    return {"dtype": str(got.dtype), "equal_fma": float((got == fma).float().mean()),
            "equal_two_roundings": float((got == y.float() * m + b).float().mean())}


def _l2norm_layouts(device):
    """Share of ``layers.l2_normalize_scale`` outputs equal between the same
    bf16 NHWC values laid out NHWC and as a permuted NCHW view: its float32
    sum over channels runs in another order on the second."""
    import torch

    from ssd_tensorflow_tpu_torch.models.layers import l2_normalize_scale

    g = torch.Generator(device=device).manual_seed(3)
    nchw = torch.relu(torch.randn((8, 512, 64, 64), generator=g, device=device)).to(torch.bfloat16)
    scale = torch.full((512,), 20.0, device=device)
    a = l2_normalize_scale(nchw.permute(0, 2, 3, 1).contiguous(), scale)
    b = l2_normalize_scale(nchw.permute(0, 2, 3, 1), scale)
    return {"equal_share": float((a == b).float().mean())}


def _layers(bundle, batch, seed, device):
    import numpy as np
    import torch

    from ssd_tensorflow_tpu_torch.inference import InferenceModel
    from ssd_tensorflow_tpu_torch.models import quantized
    from ssd_tensorflow_tpu_torch.ops import int8_conv as ic

    model = InferenceModel.from_bundle(bundle, device=device)
    size = model.preset.image_size
    images = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (batch, size.h, size.w, 3), dtype=np.uint8)).to(device)
    rows = []

    def compare(xq, wt, stride=1, padding="SAME", dilation=1):
        got = ic.int8_conv(xq, wt, stride, padding, dilation)
        want = ic.int8_conv_plain(xq, wt, stride, padding, dilation)
        rows.append({"x": list(xq.shape), "k": [wt.kh, wt.kw, wt.cin, wt.cout], "stride": stride,
                     "padding": padding, "dilation": dilation,
                     "unequal": int((got != want).sum()), "max_abs_sum": int(want.abs().max())})
        return got

    with torch.inference_mode(), mock.patch.object(quantized, "int8_conv", compare):
        model.forward_scores(images)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bundle", default="assets/vgg512_int8_minivoc.ssdtpu.npz")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/int8_probe.json")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_int8_probe: needs a GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    layers = _layers(args.bundle, args.batch, args.seed, device)
    result = {"card": smi.splitlines()[0], "torch": torch.__version__,
              "int_mm_layouts": _layouts(device), "int_mm_rates": _rates(device),
              "addcmul": _addcmul(device), "l2norm_layouts": _l2norm_layouts(device),
              "batch": args.batch, "layers": layers,
              "layers_unequal": sum(r["unequal"] for r in layers)}
    text = json.dumps(result, indent=1)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(text + "\n")
    print(text)
    return 0 if result["layers_unequal"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
