"""Mean ms between CUDA events around the harness's own call of
``InferenceModel.forward_scores`` (the span ``h100bench.forward``), over the
untraced requests of a traced run."""


def read(ctx):
    d = ctx["plain"]["spans"].get("forward")
    return sum(d) / len(d) if d else None
