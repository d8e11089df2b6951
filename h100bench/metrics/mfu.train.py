"""The model's operations in the untraced part of a traced window (each
image's train step: the forward, the data gradients but conv1_1's, the filter gradients, counted by
``benchlib/counts.py``) over that part's time times the configuration's
dense peak."""


def read(ctx):
    p = ctx["plain"]
    if p["window_s"] <= 0 or not p["items"]:
        return None
    return 100.0 * p["items"] * ctx["train_ops_per_item"] / (p["window_s"] * ctx["peak_ops"])
