"""Geometry ops and the hand-written CUDA kernels (``csrc/``)."""
