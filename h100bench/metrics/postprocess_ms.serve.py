"""Mean ms between CUDA events around the harness's own call of
``InferenceModel.ops.postprocess.decode_scores`` (the span ``h100bench.postprocess``), over the
untraced requests of a traced run."""


def read(ctx):
    d = ctx["plain"]["spans"].get("postprocess")
    return sum(d) / len(d) if d else None
