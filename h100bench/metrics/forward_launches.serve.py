"""Launch calls a batch of the forward: the main thread's runtime and driver
calls that launch a kernel or a CUDA graph (``cudaLaunchKernel`` and its
kin, ``cuLaunch*``, ``cudaGraphLaunch``) that fall inside the
``h100bench.forward`` spans (the harness's own call of
``InferenceModel.forward_scores``) of the host phase of a traced window,
over those spans. It reads only ``Trace.host``, as
``norm_launches.serve.py`` does. A forward replayed as one CUDA graph reads
1; one launched kernel by kernel reads its kernels' launches. None where
the trace holds no such span or no launch (a run on the CPU)."""

import bisect

BATCH = "h100bench.forward"
#: runtime and driver calls that launch a kernel or a graph
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch")


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.main_tid is None:
        return None
    batches = sorted((max(s, tr.t0), min(e, tr.t1)) for s, e, n in tr.host
                     if n == BATCH and e > tr.t0 and s < tr.t1)
    launches = [s for s, _, n in tr.host if n.startswith(LAUNCH_PREFIXES)]
    if not batches or not launches:
        return None
    starts = [s for s, _ in batches]
    n = 0
    for t in launches:
        i = bisect.bisect_right(starts, t) - 1
        n += i >= 0 and t <= batches[i][1]
    return n / len(batches)
