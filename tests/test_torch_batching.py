"""``ops/batching.apply_clipwise`` on the CPU: one flat call of ``fn`` per
chunk of frames, split back at the clips' offsets, against ``fn`` applied
clip by clip.  The page-locked staging on a CUDA device is held in
``tests/test_torch_cuda.py``.

Equality is exact, but for ``rot6d_to_aa``: its ``atan2`` takes the CPU's
vectorised version for most elements and the scalar libm one for a batch's
last few, and the two differ in the last place, so which frames round which
way depends on the batch's length (any batch, padded or flat).  Those are
held within 2 ulp.
"""

import numpy as np
import pytest
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import (
    batching,
    kinematics,
    rotations,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils import profiling

LENGTHS = {
    "ragged": [1, 1920, 3, 17, 64, 65, 256, 300, 7, 1000],
    "single": [300],
    "with_empty": [5, 0, 9],
}
ROOT = np.array([0, 0, 0, 0, 1, 0], np.float32)


@pytest.fixture(autouse=True)
def tracer_off():
    profiling.enable()
    profiling.disable()
    yield
    profiling.enable()
    profiling.disable()


def _aa(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.uniform(0.2, 1.2, (T, 144)).astype(np.float32) for T in lengths]


def _conversion(name, lengths):
    """(list API call, clip function with its args, input clips)."""
    aa = _aa(lengths)
    bone_len = np.random.RandomState(1).uniform(0.5, 1.5, 49).astype(np.float32)
    fk_args = (torch.from_numpy(ROOT), torch.from_numpy(bone_len))
    if name == "xyz_to_aa":
        xyz = [kinematics.clip_aa_to_xyz(torch.from_numpy(c), *fk_args).numpy() for c in aa]
        return (lambda c: kinematics.xyz_to_aa(c, device="cpu"),
                lambda x: kinematics.clip_xyz_to_aa(x), xyz)
    if name == "aa_to_rot6d":
        return (lambda c: rotations.aa_to_rot6d(c, device="cpu"),
                rotations.clip_aa_to_rot6d, aa)
    if name == "aa_to_xyz":
        return (lambda c: kinematics.aa_to_xyz(c, ROOT, bone_len, device="cpu"),
                lambda x: kinematics.clip_aa_to_xyz(x, *fk_args), aa)
    r6d = [rotations.clip_aa_to_rot6d(torch.from_numpy(c)).numpy() if len(c)
           else np.zeros((0, 288), np.float32) for c in aa]
    return (lambda c: rotations.rot6d_to_aa(c, device="cpu"),
            rotations.clip_rot6d_to_aa, r6d)


def _assert_same(name, got, want):
    assert got.shape == want.shape
    if name == "rot6d_to_aa":
        np.testing.assert_array_max_ulp(got, want, maxulp=2)
    else:
        np.testing.assert_array_equal(got, want)


CONVERSIONS = ("xyz_to_aa", "aa_to_rot6d", "aa_to_xyz", "rot6d_to_aa")


@pytest.mark.parametrize("lengths", LENGTHS.values(), ids=LENGTHS.keys())
@pytest.mark.parametrize("name", CONVERSIONS)
def test_flat_call_equals_clip_by_clip(name, lengths):
    api, clip_fn, clips = _conversion(name, lengths)
    profiling.enable()
    out = api(clips)
    profiling.disable()
    assert profiling.snapshot()["counts"] == {"convert.calls": 1}
    assert len(out) == len(clips)
    width = max(o.shape[1] for o in out)
    for got, c in zip(out, clips):
        if len(c) == 0:  # the clip functions reshape by -1: no frames, no call
            assert got.shape == (0, width)
            continue
        _assert_same(name, got, clip_fn(torch.from_numpy(c)).numpy())
    # views of one array, in the clips' order
    assert all(o.base is not None and o.base is out[0].base for o in out)


def test_empty_list_gives_empty_list():
    profiling.enable()
    assert batching.apply_clipwise(rotations.clip_aa_to_rot6d, [], device="cpu") == []
    assert rotations.aa_to_rot6d([], device="cpu") == []
    profiling.disable()
    assert profiling.snapshot()["counts"] == {}


@pytest.mark.parametrize("name", CONVERSIONS)
def test_chunks_over_the_cap_give_the_same_result(name, monkeypatch):
    api, clip_fn, clips = _conversion(name, LENGTHS["ragged"])
    whole = api(clips)
    monkeypatch.setattr(batching, "CHUNK_FRAMES", 500)
    profiling.enable()
    chunked = api(clips)
    profiling.disable()
    total = sum(len(c) for c in clips)
    assert profiling.snapshot()["counts"] == {"convert.calls": -(-total // 500)}
    for got, want, c in zip(chunked, whole, clips):
        _assert_same(name, got, clip_fn(torch.from_numpy(c)).numpy())
        if name != "rot6d_to_aa":
            np.testing.assert_array_equal(got, want)


def test_one_call_for_a_partition_of_the_lift_cell():
    """778 clips of the lift cell's length distribution (lognormal, median
    256, clipped to 32-1,920; ~237K frames) take one call: a How2Sign
    partition is one chunk."""
    rng = np.random.RandomState(0)
    lengths = np.clip(np.rint(rng.lognormal(np.log(256), 0.668, 778)), 32, 1920).astype(int)
    assert lengths.sum() <= batching.CHUNK_FRAMES
    clips = [np.full((T, 3), i, np.float32) for i, T in enumerate(lengths)]
    profiling.enable()
    out = batching.apply_clipwise(lambda x: x * 2, clips, device="cpu")
    profiling.disable()
    assert profiling.snapshot()["counts"] == {"convert.calls": 1}
    for i, (o, T) in enumerate(zip(out, lengths)):
        assert o.shape == (T, 3) and (o == 2 * i).all()


def test_args_reach_every_chunk(monkeypatch):
    monkeypatch.setattr(batching, "CHUNK_FRAMES", 4)
    clips = [np.arange(T * 2, dtype=np.float32).reshape(T, 2) for T in (3, 6, 1)]
    out = batching.apply_clipwise(lambda x, k, b: x * k + b, clips,
                                  torch.tensor(3.0), torch.tensor(1.0), device="cpu")
    for o, c in zip(out, clips):
        np.testing.assert_array_equal(o, c * 3 + 1)


def test_wide_frames_take_chunks_that_fit_the_stage(monkeypatch):
    """A chunk never holds more input bytes than one page-locked buffer."""
    monkeypatch.setattr(batching, "STAGE_BYTES", 4 * 144 * 100)
    api, clip_fn, clips = _conversion("aa_to_rot6d", LENGTHS["ragged"])
    profiling.enable()
    out = api(clips)
    profiling.disable()
    total = sum(len(c) for c in clips)
    assert profiling.snapshot()["counts"] == {"convert.calls": -(-total // 100)}
    for got, c in zip(out, clips):
        np.testing.assert_array_equal(got, clip_fn(torch.from_numpy(c)).numpy())
