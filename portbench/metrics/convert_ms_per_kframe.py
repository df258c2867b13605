"""Milliseconds per 1,000 input frames of the harness's span around each
conversion: ``xyz_to_aa``, ``aa_to_rot6d``, ``make_equal_len`` and the
standardization, over the window."""


def read(r):
    if not r.counts.get("input_frames"):
        return None
    return 1e3 * sum(r.spans["convert"]) / (r.counts["input_frames"] / 1e3)
