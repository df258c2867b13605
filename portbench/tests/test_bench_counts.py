"""The yardstick's counts: the FLOPs of both configurations against
``torch.utils.flop_counter`` over the plain reference's forward, and the
kernels' operations and bytes against a hand count."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import core, counts
from portbench.reference import models


def _cfg(name):
    return core.read_json(core.BENCH / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", ["v1_arm2wh", "v2_text_finger1_robust"])
def test_forward_flops_match_flop_counter(name):
    cfg = _cfg(name)
    B, T = 2, cfg["window_t"]
    net = models.build_generator(cfg, 0, torch.float32)
    x = torch.zeros(B, cfg["feature_in_dim"], T)
    f = torch.zeros(B, 512) if cfg["require_text"] else None
    with FlopCounterMode(display=False) as fc:
        net(x, f)
    assert counts.generator_flops(cfg, B, T) == fc.get_total_flops()
    disc = models.build_discriminator(cfg, 1, torch.float32)
    with FlopCounterMode(display=False) as fc:
        disc(torch.zeros(B, cfg["feature_out_dim"], T - 1))
    assert counts.discriminator_flops(cfg, B, T) == fc.get_total_flops()


def test_published_forward_sizes():
    """~62.5 GFLOP for v1 and ~135 for v2 with text, at B=128, T=192."""
    assert counts.generator_flops(_cfg("v1_arm2wh"), 128, 192) == 62_492_246_016
    assert counts.generator_flops(_cfg("v2_text_finger1_robust"), 128, 192) == 135_053_443_072


def test_step_rule():
    cfg = _cfg("v1_arm2wh")
    g, d = counts.generator_flops(cfg, 8, 64), counts.discriminator_flops(cfg, 8, 64)
    assert counts.step_flops(cfg, "g", 8, 64) == 3 * g + d
    assert counts.step_flops(cfg, "d", 8, 64) == g + 6 * d
    assert counts.step_flops(cfg, "val", 8, 64) == g


def test_conv_transpose_count_by_hand():
    m = torch.nn.ConvTranspose1d(4, 3, 7, stride=2, padding=3, output_padding=1)
    # each of the 2 x 4 x 5 inputs meets 3 x 7 weights
    assert counts.layer_flops(m, (2, 4, 5)) == 2 * (2 * 4 * 5) * 3 * 7


def test_filter_count_by_hand():
    # two clips of 3 and 5 frames: 8 live frames x 50 joints, 10 cycles
    live = 8 * 50
    assert counts.filter_flops(live, 10) == 16 * 400 * 10
    assert counts.filter_bound_s(live, 10) == max(16 * 400 * 10 / 67e12, 36 * 400 / 3.35e12)


def test_robust_count_by_hand():
    assert counts.robust_bytes(3, 5) == 12 * 15 + 8 * 5
    assert counts.robust_bound_s(128, 4608) == (12 * 128 * 4608 + 8 * 4608) / 3.35e12
