"""PyTorch/CUDA port of the multimodal hand-pose enhancement framework.

A second package beside the JAX one, held against it module by module.
It imports torch, numpy and scipy only.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``; on a CUDA tensor every
hand-written kernel launches (or raises), and on a CPU tensor its plain
PyTorch version runs.

Layout mirrors the JAX package: ``ops/`` (geometry and the Hopper
kernels), ``lifting/`` (2D -> 3D engine), ``models/`` (generators and the
weights bridge), ``data/`` (pickles, windows, standardization),
``train/`` (checkpoint loading) and ``infer.py`` (enhancement forward and
result pickles).
"""
