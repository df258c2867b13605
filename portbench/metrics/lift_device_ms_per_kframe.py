"""Device milliseconds per 1,000 input frames in the traced partition (lifting,
conversion and forward): the card's share, read beside ``lift_frames_per_s``,
which the host's speed moves."""

from portbench.harness.readers import device_ms_per


def read(r):
    return device_ms_per(r, "frames", 1000)
