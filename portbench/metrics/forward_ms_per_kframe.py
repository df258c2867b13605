"""Milliseconds per 1,000 input frames of the harness's span around each
``run_inference`` call (it returns host arrays), over the window."""


def read(r):
    if not r.counts.get("input_frames"):
        return None
    return 1e3 * sum(r.spans["forward"]) / (r.counts["input_frames"] / 1e3)
