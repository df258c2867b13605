"""The requests' share of the card's FP32 peak: the generator forward's
operations on every request's windows over the window's time."""

from portbench.harness.readers import mfu as read  # noqa: F401
