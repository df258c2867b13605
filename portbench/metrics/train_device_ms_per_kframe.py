"""Device milliseconds per 1,000 trained frames in the traced cycle (G, D and
val steps' B x T frames): the card's share of a training cycle, read beside
``train_frames_per_s``, which the host's speed moves."""

from portbench.harness.readers import device_ms_per


def read(r):
    return device_ms_per(r, "frames", 1000)
