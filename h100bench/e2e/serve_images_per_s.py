"""Images whose detections reached the host in the window, over the
window's time (host clock, from the first request to the last completion)."""


def read(rec):
    if rec["kind"] != "serve" or rec["window_s"] <= 0:
        return None
    return rec["items"] / rec["window_s"]
