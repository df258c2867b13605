"""The control comes out not correct: the plain reference in the program's
place, a precision below what the configuration states (TF32 for the float32
convolutions with TF32 off, bfloat16 for the float32 elementwise lifting and
conversion), judged as the program is, fails a limit; the program at the same
small size passes.  On the card only (the CPU has no TF32):

    python -m pytest -m cuda portbench/tests/test_bench_control.py
"""

from __future__ import annotations

import importlib

import pytest
import torch

from bench_small import CELLS, small
from portbench.harness import compare, core


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control's TF32 exists only on the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_program_passes(cell, card):
    _, cfg, traffic, limits = core.cell_files(core.benchmark(), cell)
    cfg, traffic = small(cfg, traffic)
    mix = importlib.import_module(f"portbench.generators.{traffic['generator']}")
    c = mix.Cell(cfg, traffic, 2**31 + 3, card, core.Recorder())
    c.window(0.0)
    c.free()
    readings = mix.calibrate(c)
    assert compare.judged(readings["program"], limits)[1], readings["program"]
    assert not compare.judged(readings["control"], limits)[1], readings["control"]
