"""Device ms a batch of the depthwise stencils: the kernels that the
program's ``ssd.depthwise`` spans (``models/layers.depthwise_conv2d``)
launch for the convolution itself, found in the host phase's trace by
name (``Trace.kernel_us``), over its ``h100bench.forward`` spans. The
casts and the bias add around the stencil are elementwise kernels that
other layers launch too, so they are left out. None where no such kernel
ran.

The name was read off a traced forward of the shipped mobilenet320 bundle
at b64 on an H100 80GB HBM3 (torch 2.11.0+cu128, CUDA 12.8): inside
``ssd.depthwise`` the host runs ``aten::cudnn_convolution`` (the input is
a channels-last view), which launches cuDNN's ``conv2d_c1_k1_nhwc`` once a
conv, 13 a batch, about 1.0 ms of the span's 4.1; the rest is the casts
to and from float32, the bf16 bias add and four TF SAME pads."""

#: substrings of the stencil kernels' names, each naming a distinct kernel
KERNELS = ("conv2d_c1_k1_nhwc",)
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
