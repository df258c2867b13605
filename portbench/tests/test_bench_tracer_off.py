"""The end-to-end metrics are measured with the port's tracer
(``utils/profiling``) off: a ``--trace 0`` rehearsal of each cell leaves it
off, with nothing recorded."""

from __future__ import annotations

import pytest

from bench_small import CELLS
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils import profiling
from test_bench_rehearsal import rehearse


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_leaves_the_tracer_off(cell, capsys):
    profiling.enable()
    profiling.disable()  # off, its totals empty
    line = rehearse(cell, 0, capsys)
    assert line["correct"], line["checks"]
    assert profiling.span("probe") is profiling.span("probe")  # the shared null context
    assert profiling.snapshot() == {"spans": {}, "counts": {}}
