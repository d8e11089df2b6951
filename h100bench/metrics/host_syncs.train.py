"""Runtime calls of the main thread that block it until the device
catches up (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``, the blocking ``cudaMemcpy``) inside
``h100bench.step`` spans, per step, in the host phase of a traced window
(``benchlib/program.py``)."""

from benchlib import program


def read(ctx):
    return program.syncs_per_step(ctx["trace"])
