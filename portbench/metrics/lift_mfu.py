"""The whole lift-and-enhance chain's share of the card's FP32 peak: the
generator forward's operations on the windows and the filter's (16 per live
joint-step per cycle) over the window's time."""

from portbench.harness.readers import mfu as read  # noqa: F401
