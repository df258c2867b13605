"""Milliseconds per 1,000 input frames of the harness's span around each
``lift_clips`` call (pack, initialization and the filter; it returns host
arrays), over the window."""


def read(r):
    if not r.counts.get("input_frames"):
        return None
    return 1e3 * sum(r.spans["lift"]) / (r.counts["input_frames"] / 1e3)
