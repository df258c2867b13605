"""Port's lifting modules (pose2d, init3d, filtering, engine) against the JAX package.

Inputs are synthetic OpenPose-like (T, 150) clips made with numpy, as in
demo.py:65-67 (pixel coordinates U(100, 500), confidences U(0.5, 1), a few
low-confidence frames so pruning bites).

Tolerances.  atol 2e-4, the JAX package's lifting tolerance
(test_pallas_kernels.py:132-139), holds for the 2D stages, for x and y at
every stage, and for the per-joint error (MPJPE) of the lifted clips.  The
z coordinate gets Z_ATOL = 2e-3: the reference's initialization is
ill-conditioned in z at float32, so any last-bit difference between two
float32 implementations shows up there at about 1e-3.
test_initialization_z_is_float32_noise demonstrates it: a one-ulp change of
the bone-length classes moves the port's own z by more than 2e-4 (x and y
by under 1e-5), and against a float64 evaluation of the same algorithm the
JAX package's float32 z and the port's are off by the same amount (about
1.5e-3) while their x and y are within 1e-5.  The bone-length medians are
one source of such differences (each class's median bone-frame has
L = exp(log(d)) ~= d, so its out-of-plane hypothesis sqrt(L^2 - d^2) is the
square root of a rounding-level number), but not the only one: fed the same
bone lengths bit for bit, the two packages' z still differ by ~1e-3.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_hand_pose_enhancement_for_sign_language_tpu.lifting import (
    engine,
    filtering,
    init3d,
    pose2d,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.lifting import (
    engine as t_engine,
    filtering as t_filtering,
    init3d as t_init3d,
    pose2d as t_pose2d,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import (
    lift_init as t_lift_init,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils import profiling

ATOL = 2e-4  # test_pallas_kernels.py:139
Z_ATOL = 2e-3  # z, float32-ill-conditioned; see the module docstring
LENGTHS = (30, 64, 100)  # two T-buckets (64, 128), two masked clips


def _clip(rng, T, pruned=True):
    kp = rng.uniform(100, 500, size=(T, 150)).astype(np.float32)
    kp[:, 2::3] = rng.uniform(0.5, 1.0, size=(T, 50))
    if pruned:
        kp[T // 3, 2:24:3] = 0.1  # one frame below the prune threshold
    return kp


def _padded(rng, lengths=(30, 64), tb=64):
    """A bucket: (B, tb, 150) keypoints, (B, tb) mask, (B, 3, tb) noise."""
    B = len(lengths)
    kps = np.zeros((B, tb, 150), np.float32)
    masks = np.zeros((B, tb), np.float32)
    noises = np.zeros((B, 3, tb), np.float32)
    for b, T in enumerate(lengths):
        kps[b, :T] = _clip(rng, T)
        masks[b, :T] = 1.0
        noises[b, :, :T] = engine._clip_noise(T)
    return kps, masks, noises


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_normalization_and_prune(rng):
    kps, masks, _ = _padded(rng)
    Xx, Xy, Xw = kps[:, :, 0::3], kps[:, :, 1::3], kps[:, :, 2::3]
    ox, oy, mux, muy, sig = t_pose2d.normalization(*_t(Xx, Xy), mask=_t(masks)[0])
    px, py, pw = t_pose2d.prune(ox, oy, *_t(Xw), range(8), 0.3)
    for b in range(kps.shape[0]):
        rx, ry, rmx, rmy, rs = pose2d.normalization(Xx[b], Xy[b], mask=masks[b])
        np.testing.assert_allclose(ox[b].numpy(), np.asarray(rx), atol=ATOL)
        np.testing.assert_allclose(oy[b].numpy(), np.asarray(ry), atol=ATOL)
        np.testing.assert_allclose(float(sig[b]), float(rs), rtol=1e-5)
        qx, qy, qw = pose2d.prune(rx, ry, Xw[b], range(8), 0.3)
        np.testing.assert_allclose(px[b].numpy(), np.asarray(qx), atol=ATOL)
        np.testing.assert_array_equal(pw[b].numpy(), np.asarray(qw))
    assert float(pw[0, 30 // 3].abs().sum()) == 0.0  # the pruned frame


def test_interpolation(rng):
    kp = _clip(rng, 24)
    Xw = kp[:, 2::3].copy()
    Xw[::5] = 0.0  # gaps the window must grow over
    mask = np.ones(24, np.float32)
    mask[20:] = 0.0
    ours = t_pose2d.interpolation(*_t(kp[:, 0::3], kp[:, 1::3], Xw), 0.99,
                                  mask=_t(mask)[0])
    ref = pose2d.interpolation(
        *(jnp.asarray(a) for a in (kp[:, 0::3], kp[:, 1::3], Xw)), 0.99,
        mask=jnp.asarray(mask),
    )
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=ATOL)


def _prepped(kps, masks):
    """The engine's pre-initialization planes, from the JAX package."""
    out = []
    for b in range(kps.shape[0]):
        m = masks[b]
        x, y, _, _, _ = pose2d.normalization(kps[b, :, 0::3], kps[b, :, 1::3], mask=m)
        x, y, w = pose2d.prune(x, y, kps[b, :, 2::3], range(8), 0.3)
        out.append([np.asarray(a) * m[:, None] for a in (x, y, w)])
    return [np.stack([o[k] for o in out]) for k in range(3)]


def test_initialization_and_fk(rng):
    kps, masks, noises = _padded(rng)
    Xx, Xy, Xw = _prepped(kps, masks)
    ours = t_init3d.initialization(*_t(Xx, Xy, Xw), noise=_t(noises)[0],
                                   mask=_t(masks)[0])
    fk = t_filtering.fk_from_angles(*ours[:7])
    for b in range(kps.shape[0]):
        ref = init3d.initialization(Xx[b], Xy[b], Xw[b], 0.001, noise=noises[b],
                                    mask=masks[b])
        valid = masks[b] > 0
        np.testing.assert_allclose(ours[0][b].numpy(), np.asarray(ref[0]),
                                   rtol=1e-5, atol=ATOL)
        rfk = filtering.fk_from_angles(*(jnp.asarray(a) for a in ref[:7]))
        # roots, angles, Y and the FK snapshot, each (T, k); z last of each
        pairs = list(zip(ours[1:], ref[1:])) + list(zip(fk, rfk))
        z_planes = {2, 5, 8, 11}
        for i, (o, r) in enumerate(pairs):
            tol = Z_ATOL if i in z_planes else ATOL
            np.testing.assert_allclose(o[b].numpy()[valid], np.asarray(r)[valid],
                                       atol=tol)


def _bits_equal(a, b):
    """Equal bit for bit, or NaN where the other is NaN."""
    a, b = a.contiguous(), b.contiguous()
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())
    return bool(same.all())


def test_init_core_is_initialization_then_fk(rng):
    """The engine's pre-filter pipeline, now through ``ops/lift_init`` (its
    plain version on the CPU), gives what ``initialization`` then
    ``fk_from_angles`` give, bit for bit, also in the all-masked padding row
    (whose bone lengths are infinite), and counts no kernel launch."""
    # a third row of zeros: the pow2 padding of a batch
    kps, masks, noises = _t(*(np.concatenate([a, np.zeros_like(a[:1])])
                              for a in _padded(rng)))
    before = t_lift_init.lift_init.launches
    profiling.enable()
    try:
        x0, y0, z0, Xx, Xy, Xw = t_engine._init_core(kps, masks, noises)
        counts = profiling.snapshot()["counts"]
    finally:
        profiling.disable()
    init = t_init3d.initialization(Xx, Xy, Xw, 0.001, noise=noises, mask=masks)
    want = t_filtering.fk_from_angles(*init[:7])
    for got, w in zip((x0, y0, z0), want):
        assert _bits_equal(got, w)
        assert bool(got[:2].isfinite().all()) and not bool(got[2].isfinite().all())
    assert t_lift_init.lift_init.launches == before
    assert "lift.init_kernel" not in counts


def test_initialization_z_is_float32_noise(rng, monkeypatch):
    """Why z is held at Z_ATOL: the initialization's z is float32 rounding
    noise amplified, in the JAX package as much as in the port."""
    kps, masks, noises = _padded(rng)
    Xx, Xy, Xw = _prepped(kps, masks)
    args = _t(Xx, Xy, Xw)
    kw = {"noise": _t(noises)[0], "mask": _t(masks)[0]}
    ours = t_init3d.initialization(*args, **kw)
    exact = t_init3d.initialization(*(a.double() for a in args),
                                    **{k: v.double() for k, v in kw.items()})
    planes = {"x": 7, "y": 8, "z": 9}  # Yx, Yy, Yz, each (B, T, 50)
    port_err = dict.fromkeys(planes, 0.0)
    jax_err = dict.fromkeys(planes, 0.0)
    for b in range(kps.shape[0]):
        ref = init3d.initialization(Xx[b], Xy[b], Xw[b], 0.001, noise=noises[b],
                                    mask=masks[b])
        valid = masks[b] > 0
        for name, i in planes.items():
            truth = exact[i][b].numpy()[valid]
            port_err[name] = max(port_err[name],
                                 np.abs(ours[i][b].numpy()[valid] - truth).max())
            jax_err[name] = max(jax_err[name],
                                np.abs(np.asarray(ref[i])[valid] - truth).max())
    # x and y are well-conditioned: both float32 runs sit on the float64 one
    for name in ("x", "y"):
        assert port_err[name] <= 1e-5 and jax_err[name] <= 1e-5
    # z is not, for the reference as much as for the port
    assert ATOL < jax_err["z"] <= Z_ATOL
    assert port_err["z"] <= 1.5 * jax_err["z"]

    # one ulp on the bone-length classes moves z past ATOL, x and y not
    lines = t_init3d.bone_length_classes(args[0], args[1], mask=kw["mask"])
    up = torch.nextafter(lines, torch.full_like(lines, np.inf))
    monkeypatch.setattr(t_init3d, "bone_length_classes", lambda *a, **k: up)
    moved = t_init3d.initialization(*args, **kw)
    shift = {n: float((moved[i] - ours[i]).abs().max()) for n, i in planes.items()}
    assert shift["z"] > ATOL
    assert shift["x"] <= 1e-5 and shift["y"] <= 1e-5


def test_loss_value(rng):
    kps, masks, _ = _padded(rng)
    planes = [rng.randn(2, 64, 50).astype(np.float32) for _ in range(6)]
    lines = rng.randn(2, 25).astype(np.float32) * 0.1
    ours = t_filtering.loss_value(*_t(*planes, lines), mask=_t(masks)[0])
    for b in range(2):
        ref = filtering.loss_value(*(p[b] for p in planes), lines[b], mask=masks[b])
        np.testing.assert_allclose(float(ours[b]), float(ref), rtol=1e-5)


def test_bone_length_classes_per_clip_median(rng):
    """The median index differs per clip (its own real frame count)."""
    kps, masks, _ = _padded(rng, lengths=(7, 40, 64))
    Xx, Xy = kps[:, :, 0::3], kps[:, :, 1::3]
    ours = t_init3d.bone_length_classes(*_t(Xx, Xy), mask=_t(masks)[0])
    for b in range(3):
        ref = init3d.bone_length_classes(Xx[b], Xy[b], mask=masks[b])
        np.testing.assert_allclose(ours[b].numpy(), np.asarray(ref), rtol=1e-6)


def test_compute_b_guards_and_first_minimum():
    """Degenerate frames: a zero-length target (ay == ty, foo1 == 0) and
    exact ties between hypotheses, through both implementations."""
    ax = np.array([0.0, 0.0, 1.0, 0.5, 0.0], np.float32)
    ay = np.array([0.0, 1.0, 1.0, 0.5, 0.0], np.float32)
    az = np.zeros(5, np.float32)
    tx = np.array([0.0, 1.0, 2.0, 0.5, 3.0], np.float32)
    ty = np.array([0.0, 1.0, 1.0, 1.5, 4.0], np.float32)
    L = np.array([1.0, 1.0, 0.5, 1.0, 5.0], np.float32)
    ours = t_init3d.compute_b(*_t(ax, ay, az, tx, ty, L))
    ref = init3d.compute_b(*(jnp.asarray(a) for a in (ax, ay, az, tx, ty, L)))
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL)


def _assert_lift_close(ours, ref):
    for o, r in zip(ours, ref):
        assert o.shape == r.shape
        o3, r3 = o.reshape(-1, 50, 3), r.reshape(-1, 50, 3)
        np.testing.assert_allclose(o3[..., :2], r3[..., :2], atol=ATOL)
        np.testing.assert_allclose(o3[..., 2], r3[..., 2], atol=Z_ATOL)
        assert np.linalg.norm(o3 - r3, axis=-1).mean() <= ATOL


@pytest.mark.parametrize("pruned", [True, False], ids=["pruned", "unpruned"])
def test_lift_clips_matches_jax_xla(rng, pruned):
    """End to end at the production 900 cycles, three clips over two
    T-buckets (30 and 64 share the 64 bucket, 30 masked; 100 pads to 128),
    with and without a frame below the prune threshold in each clip."""
    clips = [_clip(rng, T, pruned) for T in LENGTHS]
    ours = t_engine.lift_clips(clips, n_cycles=900, device="cpu")
    ref = engine.lift_clips(clips, n_cycles=900, filter_impl="xla")
    assert [o.shape for o in ours] == [(T, 150) for T in LENGTHS]
    _assert_lift_close(ours, ref)


def test_lift_2d_to_3d_resume(tmp_path, rng):
    """Partitioned file contract as the JAX engine (test_lifting.py:191):
    a complete file resumes without recomputing, and a file holding the
    first partition resumes with the rest."""
    clips = [_clip(rng, 16) for _ in range(4)]
    fname = str(tmp_path / "feats_3d.pkl")
    out = t_engine.lift_2d_to_3d(clips, fname, nPartitions=2, n_cycles=10,
                                 device="cpu")
    assert len(out) == 4 and os.path.exists(fname)
    again = t_engine.lift_2d_to_3d(clips, fname, nPartitions=2, n_cycles=10,
                                   device="cpu")
    assert len(again) == 4
    for a, b in zip(out, again):
        np.testing.assert_array_equal(a, b)
    # a run that stopped after the first partition (3 clips: idx = 4 // 2 + 1)
    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.io import (
        save_binary,
    )

    save_binary(out[:3], fname)
    resumed = t_engine.lift_2d_to_3d(clips, fname, nPartitions=2, n_cycles=10,
                                     device="cpu")
    ref = engine.lift_2d_to_3d(clips, str(tmp_path / "jax.pkl"), nPartitions=2,
                               n_cycles=10)
    assert len(resumed) == len(ref) == 4
    _assert_lift_close(resumed, ref)


def test_lift_clips_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        t_engine.lift_clips([np.zeros((4, 150), np.float32)], n_cycles=1)


def test_checkpoint_writer_reraises_at_join(tmp_path):
    """A failed background partition write surfaces at join(), so the run
    aborts instead of resuming later from an older on-disk prefix."""
    writer = t_engine._CheckpointWriter([1, 2], str(tmp_path / "missing" / "f.pkl"))
    writer.start()
    with pytest.raises(FileNotFoundError):
        writer.join()
