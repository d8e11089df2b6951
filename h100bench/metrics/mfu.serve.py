"""The model's operations in the untraced part of a traced window (each
image's forward: twice its convolutions' multiply-adds, counted by
``benchlib/counts.py``) over that part's time times the configuration's
dense peak."""


def read(ctx):
    p = ctx["plain"]
    if p["window_s"] <= 0 or not p["items"]:
        return None
    return 100.0 * p["items"] * ctx["forward_ops_per_item"] / (p["window_s"] * ctx["peak_ops"])
