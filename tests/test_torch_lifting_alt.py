"""The port's lifting alternatives against the JAX package's, on the CPU.

* ``ops/rotations``' matrix forms against the JAX package's, at 1e-5, on
  random rotations, angles near 0 and near pi included;
* ``init3d.add_noise`` bit for bit with the same ``RandomState``, and
  ``initialization``'s ``rng`` / ``sigma`` draws;
* ``filter_xyz`` goes through ``ops/filter_sgd``;
* ``backpropagation_based_filtering_v2`` against the JAX package's v2 at the
  lifting tolerances (x, y 2e-4; z 2e-3, float32-ill-conditioned, see
  tests/test_torch_lifting.py);
* the engine's one filter: the JAX package's ``MHPE_LIFT_*`` switches
  select nothing here, and ``lift_clips`` refuses the JAX engine's filter
  keywords; the batches in flight;
* the demo CLI's five dumps against the root ``demo.py``'s, at the lifting
  tolerances plus the dumps' 7-digit rounding.
"""

import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import demo as root_demo
from multimodal_hand_pose_enhancement_for_sign_language_tpu.lifting import (
    engine,
    filtering,
    init3d,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu.ops import rotations
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch import demo as t_demo
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.lifting import (
    engine as t_engine,
    filtering as t_filtering,
    init3d as t_init3d,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import (
    rotations as t_rotations,
)

ROT_ATOL = 1e-5
ATOL = 2e-4  # lifting x, y (test_pallas_kernels.py:44)
Z_ATOL = 2e-3  # lifting z (tests/test_torch_lifting.py)
# the dumps' "%e" keeps 7 significant digits: |values| < 20 round within 1e-5
DUMP_ATOL = 1e-5


def _rotvecs(rng, n=64):
    """Random rotation vectors with angles over (0, pi), plus angles near 0
    (the Taylor branches) and near pi (the quaternion's w near 0)."""
    axis = rng.randn(n, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = rng.uniform(0, np.pi, n)
    angle[:4] = (0.0, 1e-7, 1e-4, np.pi - 1e-3)
    return (axis * angle[:, None]).astype(np.float32)


@pytest.mark.parametrize("name", [
    "rot6d_to_mat", "mat_to_rot6d", "aa_to_mat", "mat_to_quat", "quat_to_aa",
    "mat_to_aa", "aa_to_mat_rot6d", "rot6d_to_aa_vec",
])
def test_matrix_rotations_match_jax(rng, name):
    aa = _rotvecs(rng)
    mat = np.asarray(rotations.aa_to_mat(jnp.asarray(aa)))
    r6d = (rng.randn(len(aa), 6)).astype(np.float32)
    quat = np.asarray(rotations.mat_to_quat(jnp.asarray(mat)))
    arg = {"rot6d_to_mat": r6d, "mat_to_rot6d": mat, "aa_to_mat": aa,
           "mat_to_quat": mat, "quat_to_aa": quat, "mat_to_aa": mat,
           "aa_to_mat_rot6d": aa, "rot6d_to_aa_vec": r6d}[name]
    arg = np.array(arg).reshape(4, 16, *arg.shape[1:])  # leading batch dims broadcast
    want = np.asarray(getattr(rotations, name)(jnp.asarray(arg)))
    got = getattr(t_rotations, name)(torch.from_numpy(arg)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ROT_ATOL, rtol=0)


def test_numpy_rotation_aliases_match_jax(rng):
    r6d = rng.randn(5, 7, 6).astype(np.float32)
    np.testing.assert_allclose(t_rotations.np_rot6d_to_mat(r6d),
                               rotations.np_rot6d_to_mat(r6d), atol=ROT_ATOL)
    assert t_rotations.np_rot6d_to_mat(r6d[0, 0]).shape == (9,)
    mat = t_rotations.np_rot6d_to_mat(r6d)
    for m in (mat, mat.reshape(5, 7, 3, 3), mat[0, 0]):
        np.testing.assert_array_equal(t_rotations.np_mat_to_rot6d(m),
                                      rotations.np_mat_to_rot6d(m))
    with pytest.raises(AttributeError):
        t_rotations.np_mat_to_rot6d(np.zeros((4, 5)))


def test_matrix_forms_agree_with_the_plane_forms(rng):
    """The matrix route rot6d -> mat -> aa equals the clip converter's
    plane form on the same blocks."""
    r6d = rng.randn(10, 6 * 4).astype(np.float32)
    planes = t_rotations.clip_rot6d_to_aa(torch.from_numpy(r6d))
    vec = t_rotations.rot6d_to_aa_vec(torch.from_numpy(r6d).reshape(10, 4, 6))
    np.testing.assert_allclose(vec.reshape(10, 12).numpy(), planes.numpy(), atol=ROT_ATOL)


def test_add_noise_is_bit_equal_for_the_same_random_state(rng):
    x = rng.randn(3, 40).astype(np.float32)
    want = init3d.add_noise(x, np.random.RandomState(1234), 0.001)
    got = t_init3d.add_noise(x, np.random.RandomState(1234), 0.001)
    np.testing.assert_array_equal(got, want)
    got_t = t_init3d.add_noise(torch.from_numpy(x), np.random.RandomState(1234), 0.001)
    np.testing.assert_array_equal(got_t.numpy(), want)


def test_initialization_draws_its_root_noise_from_rng(rng):
    """With ``rng`` (and no ``noise``) the roots get U(-sigma, sigma) draws
    from the generator, x then y then z; the same seed gives the same
    estimate, and ``noise`` takes precedence."""
    planes = [torch.from_numpy(rng.randn(2, 12, 50).astype(np.float32)) for _ in range(2)]
    Xw = torch.from_numpy(rng.uniform(0.5, 1, (2, 12, 50)).astype(np.float32))
    sigma = 0.01
    out = t_init3d.initialization(*planes, Xw, sigma, rng=torch.Generator().manual_seed(3),
                                  dtype="float32")
    g = torch.Generator().manual_seed(3)
    draws = [torch.rand((2, 12), generator=g) * (2 * sigma) - sigma for _ in range(3)]
    np.testing.assert_array_equal(out[1][..., 0].numpy(), (planes[0][:, :, 0] + draws[0]).numpy())
    np.testing.assert_array_equal(out[2][..., 0].numpy(), (planes[1][:, :, 0] + draws[1]).numpy())
    np.testing.assert_array_equal(out[3][..., 0].numpy(), draws[2].numpy())
    again = t_init3d.initialization(*planes, Xw, sigma, rng=torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    zero = torch.zeros(2, 3, 12)
    fixed = t_init3d.initialization(*planes, Xw, sigma, noise=zero,
                                    rng=torch.Generator().manual_seed(3))
    assert torch.equal(fixed[3], torch.zeros(2, 12, 1))


def _filter_inputs(rng, B=3, T=40):
    planes = [rng.randn(B, T, 50).astype(np.float32) for _ in range(5)]
    w = rng.rand(B, T, 50).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, 25:] = 0.0  # one short clip
    return (*planes, w * mask[:, :, None], mask)


def test_filter_xyz_goes_through_the_kernel_wrapper(rng, monkeypatch):
    """The public loop is ``ops/filter_sgd.filter_sgd`` (the kernel on a
    CUDA tensor): a mask of ones when none is given."""
    seen = []
    real = t_filtering.filter_sgd

    def spy(*a):
        seen.append(a[6])
        return real(*a)

    monkeypatch.setattr(t_filtering, "filter_sgd", spy)
    ins = [torch.from_numpy(a) for a in _filter_inputs(rng, B=2, T=16)[:6]]
    out = t_filtering.filter_xyz(*ins, 20.0, 30)
    assert len(seen) == 1 and torch.equal(seen[0], torch.ones(2, 16))
    for b in range(2):
        want = filtering.filter_xyz(*(jnp.asarray(a[b].numpy()) for a in ins),
                                    learning_rate=20.0, n_cycles=30)
        for o, w in zip(out, want):
            np.testing.assert_allclose(o[b].numpy(), np.asarray(w), atol=ATOL)


def _v2_inputs(rng, T):
    """A clip's initialization, by the JAX package, as the reference's
    single-clip arrays: lines (25,), roots (T, 1), angles (T, 49)."""
    Xx, Xy = (rng.randn(T, 50).astype(np.float32) for _ in range(2))
    Xw = rng.uniform(0.3, 1.0, (T, 50)).astype(np.float32)
    init = init3d.initialization(*(jnp.asarray(a) for a in (Xx, Xy, Xw)), 0.001,
                                 noise=engine._clip_noise(T))
    return [np.asarray(a) for a in init[:7]] + [Xx, Xy, Xw]


@pytest.mark.parametrize("masked", [False, True])
def test_v2_matches_jax(rng, masked):
    T = 48
    args = _v2_inputs(rng, T)
    mask = None
    if masked:
        mask = np.ones(T, np.float32)
        mask[40:] = 0.0
    want = filtering.backpropagation_based_filtering_v2(
        *args, None, "float32", learningRate=20.0, nCycles=300,
        mask=None if mask is None else jnp.asarray(mask))
    got = t_filtering.backpropagation_based_filtering_v2(
        *args, None, "float32", learningRate=20.0, nCycles=300, mask=mask, device="cpu")
    for g, w, tol in zip(got, want, (ATOL, ATOL, Z_ATOL)):
        assert g.shape == (T, 50)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol)
    # tensors in, and the default device is the card
    again = t_filtering.backpropagation_based_filtering_v2(
        *(torch.from_numpy(a) for a in args), nCycles=300,
        mask=None if mask is None else torch.from_numpy(mask), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_filtering.backpropagation_based_filtering_v2(*args, nCycles=1)


def _clips(rng, lengths=(30, 64, 100)):
    out = []
    for T in lengths:
        kp = rng.uniform(100, 500, size=(T, 150)).astype(np.float32)
        kp[:, 2::3] = rng.uniform(0.5, 1.0, size=(T, 50))
        out.append(kp)
    return out


def test_engine_switches(rng, monkeypatch, capsys):
    """The engine has one filter: the JAX package's environment switches
    (MHPE_LIFT_FILTER, MHPE_LIFT_PALLAS, MHPE_MATPOW_PRECISION) select
    nothing here, so ``lift_clip`` and ``lift_clips`` run the kernel's
    wrapper, and ``lift_clips`` refuses the JAX engine's keywords."""
    monkeypatch.setenv("MHPE_LIFT_FILTER", "xla")
    monkeypatch.setenv("MHPE_LIFT_PALLAS", "0")
    monkeypatch.setenv("MHPE_MATPOW_PRECISION", "bfloat16")
    ran = []
    real = t_engine.filter_sgd
    monkeypatch.setattr(t_engine, "filter_sgd", lambda *a: ran.append(a[-1]) or real(*a))
    clip = _clips(rng, (8,))
    t_engine.lift_clips(clip, n_cycles=3, device="cpu")
    t_engine.lift_clip(clip[0], n_cycles=3, device="cpu")
    assert ran == [3, 3]
    assert capsys.readouterr().out.count("lift_clips: 1 clips on cpu") == 2
    for kw in ({"filter_impl": "xla"}, {"matpow_precision": "float32"}, {"use_pallas": False}):
        with pytest.raises(TypeError):
            t_engine.lift_clips(clip, n_cycles=3, device="cpu", **kw)


@pytest.mark.parametrize("depth", ["0", "1", "3"])
def test_prefetch_depth_bounds_the_batches_in_flight(rng, monkeypatch, depth):
    """``_IN_FLIGHT`` batches stay in flight before the oldest is fetched
    (0: each is fetched before the next is enqueued); the results do not
    depend on it."""
    events = []
    real = t_engine._lift_batch

    class Fetched:
        def __init__(self, i, res):
            self.i, self.res = i, res

        def cpu(self):
            events.append(("fetch", self.i))
            return self.res.cpu()

    def run(*a):
        i = sum(e[0] == "run" for e in events)
        events.append(("run", i))
        return Fetched(i, real(*a))

    assert t_engine._IN_FLIGHT == 3
    monkeypatch.setattr(t_engine, "_IN_FLIGHT", int(depth))
    monkeypatch.setattr(t_engine, "_lift_batch", run)
    clips = _clips(rng, (8, 70, 140, 200, 260))  # five T-buckets, five batches
    got = t_engine.lift_clips(clips, n_cycles=2, device="cpu")
    for k, e in enumerate(events):
        if e[0] == "run":  # batches enqueued and not yet fetched
            fetched = sum(f[0] == "fetch" for f in events[:k])
            assert e[1] - fetched <= int(depth), events
    monkeypatch.setattr(t_engine, "_lift_batch", real)
    want = t_engine.lift_clips(clips, n_cycles=2, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def _read_dumps(d):
    return [np.loadtxt(os.path.join(d, f"demo{i}.txt")) for i in range(1, 6)]


def _hold_dumps(got, want):
    for i, (g, w) in enumerate(zip(got, want), 1):
        assert g.shape == w.shape, i
        g, w = g.reshape(len(g), -1, 3), w.reshape(len(w), -1, 3)
        np.testing.assert_allclose(g[..., :2], w[..., :2], atol=ATOL + DUMP_ATOL,
                                   err_msg=f"demo{i}")
        # demo1-3 hold (x, y, w); demo4-5 (x, y, z)
        ztol = (Z_ATOL if i >= 4 else 0.0) + DUMP_ATOL
        np.testing.assert_allclose(g[..., 2], w[..., 2], atol=ztol, err_msg=f"demo{i}")


def test_demo_dumps_match_the_root_demo(tmp_path):
    """The synthetic 64-frame sequence through both demos (the reference's
    demo-sequence.h5 is not in the repository)."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    want = root_demo.main(types.SimpleNamespace(
        input="", out_dir=jdir, max_frames=0, n_cycles=900, learning_rate=20.0))
    got = t_demo.main(t_demo.build_parser().parse_args(
        ["--out_dir", tdir, "--device", "cpu"]))
    _hold_dumps(_read_dumps(tdir), _read_dumps(jdir))
    for g, w, tol in zip(got, want, (ATOL, ATOL, Z_ATOL)):
        np.testing.assert_allclose(g, np.asarray(w), atol=tol)


@pytest.mark.parametrize("fmt", ["h5", "npy"])
def test_demo_reads_a_sequence_file(tmp_path, rng, fmt):
    """An .h5 sequence (its first dataset, as the root demo reads it) and an
    .npy one give the same dumps as the root demo on that .h5, cut by
    ``--max_frames``."""
    h5py = pytest.importorskip("h5py")
    X = _clips(rng, (90,))[0]
    path = str(tmp_path / "seq.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("seq", data=X)
    if fmt == "npy":
        np.save(str(tmp_path / "seq.npy"), X)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    root_demo.main(types.SimpleNamespace(input=path, out_dir=jdir, max_frames=70,
                                         n_cycles=200, learning_rate=20.0))
    t_demo.main(t_demo.build_parser().parse_args(
        ["--input", str(tmp_path / f"seq.{fmt}"), "--out_dir", tdir, "--max_frames", "70",
         "--n_cycles", "200", "--device", "cpu"]))
    got = _read_dumps(tdir)
    assert got[0].shape == (70, 150)
    _hold_dumps(got, _read_dumps(jdir))


def test_demo_defaults_to_cuda(tmp_path):
    args = t_demo.build_parser().parse_args(["--out_dir", str(tmp_path)])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_demo.main(args)
