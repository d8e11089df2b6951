"""Device ms a batch of RetinaNet's grouped convolutions: the kernels that
the program's ``ssd.grouped_conv`` spans (``models/layers.grouped_conv``)
launch for the convolution itself, found in the host phase's trace by name
(``Trace.kernel_us``), over its ``h100bench.forward`` spans. The casts to
and from float32, the bias add and the ReLU around them are elementwise
kernels that other layers launch too, so they are left out. None where no
such kernel ran.

The names were read off a traced retina800 forward at b64 on an H100
80GB HBM3 (torch 2.11.0+cu128, CUDA 12.8): inside ``ssd.grouped_conv``
the float32 ``F.conv2d(groups=32)`` runs as cuDNN's TF32 implicit GEMMs
``sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_..._g8`` (and ``_g4``,
``_g2``, ``_g1``), ~12.4 ms of the span's ~40; they are the only float32
convolutions of the bf16 forward, whose dense convs are bf16 kernels."""

#: substrings of the grouped convs' kernel names
KERNELS = ("f32f32_tf32f32",)
BATCH = "h100bench.forward"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.main_tid is None:
        return None
    batches = sum(1 for s, e, n in tr.host if n == BATCH and e > tr.t0 and s < tr.t1)
    us = sum(sum(tr.kernel_us(k)) for k in KERNELS)
    if not batches or us <= 0:
        return None
    return us / batches / 1e3
