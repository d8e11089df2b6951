"""Images of every SGD step of the window over the window's time; the
window ends in a synchronisation, so every counted step has completed."""


def read(rec):
    if rec["kind"] != "train" or rec["window_s"] <= 0:
        return None
    return rec["items"] / rec["window_s"]
