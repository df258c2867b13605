"""The whole training step's share of the card's FP32 peak: the window's
G, D and val steps' operations (``counts.step_flops``) over its time."""

from portbench.harness.readers import mfu as read  # noqa: F401
