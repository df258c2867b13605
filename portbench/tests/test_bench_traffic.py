"""The traffic generators: the same seed gives the same inputs, another seed
the same sizes in another order, and the sizes meet the mixes' stated means
and ranges."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.generators import enhance, gan_train, lift_enhance
from portbench.harness import core

SEED = 2**31 + 17  # seeds given to a run reach past 32 signed bits


def _traffic(name):
    return core.read_json(core.BENCH / "traffic" / f"{name}.json")


def test_partition_lengths_fixed_and_how2sign_like():
    t = _traffic("lift_enhance")
    a = lift_enhance.clip_lengths(t, t["clips_per_partition"])
    b = lift_enhance.clip_lengths(t, t["clips_per_partition"])
    assert np.array_equal(a, b)
    assert a.min() >= t["length_min"] and a.max() <= t["length_max"]
    assert 240 <= np.median(a) <= 270  # median ~256
    assert 290 <= a.mean() <= 330  # How2Sign's ~320


def _clips(seed, n=40):
    t = {**_traffic("lift_enhance"), "clips_per_partition": n}
    lengths = lift_enhance.clip_lengths(t, n)
    order = np.random.default_rng(seed).permutation(lengths)
    return t, lift_enhance.make_clips(t, order, torch.Generator().manual_seed(seed), "cpu")


def test_keypoints_deterministic_in_seed():
    _, a = _clips(SEED)
    _, b = _clips(SEED)
    _, c = _clips(SEED + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert sorted(len(x) for x in a) == sorted(len(x) for x in c)
    assert not all(np.array_equal(x, y) for x, y in zip(a, c) if len(x) == len(y))


def test_keypoints_ranges_and_pruned_share():
    t, clips = _clips(SEED, n=200)
    kp = np.concatenate(clips)
    xy = np.delete(kp, np.s_[2::3], axis=1)
    assert xy.min() >= t["xy_range"][0] and xy.max() <= t["xy_range"][1]
    conf = kp[:, 2::3]
    assert conf.min() >= 0.0 and conf.max() <= t["confidence_range"][1]
    pruned = conf[:, :8].mean(axis=1) < 0.3  # what pose2d.prune removes
    assert 0.015 <= pruned.mean() <= 0.045  # about 3%


def test_requests_fixed_sizes():
    t = _traffic("enhance")
    a, b = enhance.request_sizes(t), enhance.request_sizes(t)
    assert len(a) == t["requests"]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    n = np.array([len(x) for x in a])
    assert n.min() >= 8 and n.max() <= 20 and 12 <= n.mean() <= 16  # ~14 a video


def test_training_pool_deterministic_in_seed():
    cfg = core.read_json(core.BENCH / "configs" / "v2_text_finger1_robust.json")
    cfg = {**cfg, "window_t": 16}
    a = gan_train.make_pool(4, cfg, SEED, torch.device("cpu"), 0)
    b = gan_train.make_pool(4, cfg, SEED, torch.device("cpu"), 0)
    c = gan_train.make_pool(4, cfg, SEED + 1, torch.device("cpu"), 0)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert a[0].shape == (4, 16, 264) and a[1].shape == (4, 16, 24) and a[2].shape == (4, 512)
    assert abs(float(a[0].mean())) < 0.1 and 0.9 < float(a[0].std()) < 1.1


@pytest.mark.parametrize("name", ["train", "lift_enhance", "enhance"])
def test_traffic_names_its_generator(name):
    import importlib

    mix = importlib.import_module(f"portbench.generators.{_traffic(name)['generator']}")
    assert hasattr(mix, "Cell") and hasattr(mix, "calibrate")
