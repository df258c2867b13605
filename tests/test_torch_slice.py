"""The whole serving chain on both packages: 2D keypoints -> lifting ->
xyz -> aa -> r6d -> windows -> standardize -> v1 forward -> save_results.

Synthetic (T, 150) keypoints as in demo.py:65-67; the lifting runs a
reduced 120 cycles to keep the test short (the 900-cycle filter is held in
test_torch_filter.py and test_torch_lifting.py).  Each package runs the
chain on its own outputs; stage checks feed both packages the same input
so each stage is held at its own tolerance, and the final check is the
end-to-end xyz MPJPE of the two independent chains against the 1e-3
budget of BASELINE.json.
"""

import os

import numpy as np
import torch

import jax

from multimodal_hand_pose_enhancement_for_sign_language_tpu import infer
from multimodal_hand_pose_enhancement_for_sign_language_tpu.data import (
    standardize,
    windows,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu.data.io import (
    load_binary,
    save_binary,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu.lifting import engine
from multimodal_hand_pose_enhancement_for_sign_language_tpu.models import registry
from multimodal_hand_pose_enhancement_for_sign_language_tpu.ops import (
    kinematics,
    rotations,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch import (
    infer as t_infer,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.lifting import (
    engine as t_engine,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import (
    convert,
    registry as t_registry,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import (
    kinematics as t_kin,
    rotations as t_rot,
)

LIFT_ATOL = 2e-4  # test_pallas_kernels.py:139 (x, y and per-joint error)
LIFT_Z_ATOL = 2e-3  # z is float32-ill-conditioned: see test_torch_lifting.py
GEOM_ATOL = 1e-4  # test_kinematics.py:52
FWD_ATOL = 2e-4  # STATUS.md:363
MPJPE_BUDGET = 1e-3  # BASELINE.json
LENGTHS = (40, 96, 150, 230)
N_CYCLES = 120


def _clips(rng):
    out = []
    for T in LENGTHS:
        kp = rng.uniform(100, 500, size=(T, 150)).astype(np.float32)
        kp[:, 2::3] = rng.uniform(0.5, 1.0, size=(T, 50))
        out.append(kp)
    return out


def _mpjpe(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm((a - b).reshape(*a.shape[:-1], 50, 3), axis=-1).mean())


def _windows_and_stats(r6d):
    w = windows.make_equal_len(r6d, method="cutting+reflect")
    X, Y = w[:, :, :36], w[:, :, 36:288]
    stats = standardize.calc_standard(X.transpose(0, 2, 1), Y.transpose(0, 2, 1),
                                      "arm2wh")
    return X.astype(np.float32), Y.astype(np.float32), stats


def _chain_jax(clips, variables, module, data_dir, base):
    xyz = engine.lift_clips(clips, n_cycles=N_CYCLES, filter_impl="xla")
    save_binary(xyz, os.path.join(data_dir, "xyz_train"))
    r6d = rotations.aa_to_rot6d(kinematics.xyz_to_aa(xyz))
    X, Y, (mX, sX, mY, sY) = _windows_and_stats(r6d)
    Xs = ((X - mX.transpose(0, 2, 1)) / sX.transpose(0, 2, 1)).astype(np.float32)
    out, _ = infer.run_inference(module, variables, Xs, batch_size=3,
                                 matmul_precision="float32")
    out = (out * sY.transpose(0, 2, 1) + mY.transpose(0, 2, 1)).astype(np.float32)
    path = infer.save_results(X, out, "arm2wh", base, data_dir, tag="jax",
                              infer_set="test")
    return xyz, r6d, load_binary(path)


def _chain_port(clips, net, data_dir, base):
    xyz = t_engine.lift_clips(clips, n_cycles=N_CYCLES, device="cpu")
    save_binary(xyz, os.path.join(data_dir, "xyz_train"))
    r6d = t_rot.aa_to_rot6d(t_kin.xyz_to_aa(xyz, device="cpu"), device="cpu")
    X, Y, (mX, sX, mY, sY) = _windows_and_stats(r6d)
    Xs = ((X - mX.transpose(0, 2, 1)) / sX.transpose(0, 2, 1)).astype(np.float32)
    out, _ = t_infer.run_inference(net, Xs, batch_size=3,
                                   matmul_precision="float32", device="cpu")
    out = (out * sY.transpose(0, 2, 1) + mY.transpose(0, 2, 1)).astype(np.float32)
    path = t_infer.save_results(X, out, "arm2wh", base, data_dir, tag="port",
                                infer_set="test", device="cpu")
    return xyz, r6d, load_binary(path)


def test_serving_chain_matches_jax(tmp_path, monkeypatch, rng):
    monkeypatch.chdir(tmp_path)  # save_results writes root.pkl/bone_len.pkl here
    clips = _clips(rng)
    module = registry.build_generator("v1", 36, 252, default_size=32)
    variables = jax.tree.map(
        np.asarray, registry.init_generator(module, jax.random.PRNGKey(0), T=192)
    )
    net = t_registry.build_generator("v1", 36, 252, default_size=32, device="cpu")
    net.load_state_dict(convert.generator_state_dict(variables), strict=True)

    dirs = {k: tmp_path / k for k in ("jax", "port")}
    for d in dirs.values():
        d.mkdir()
    j_xyz, j_r6d, j_res = _chain_jax(clips, variables, module, str(dirs["jax"]),
                                     str(dirs["jax"]))
    p_xyz, p_r6d, p_res = _chain_port(clips, net, str(dirs["port"]), str(dirs["port"]))

    # stage 1: lifting
    for o, r in zip(p_xyz, j_xyz):
        o3, r3 = o.reshape(-1, 50, 3), r.reshape(-1, 50, 3)
        np.testing.assert_allclose(o3[..., :2], r3[..., :2], atol=LIFT_ATOL)
        np.testing.assert_allclose(o3[..., 2], r3[..., 2], atol=LIFT_Z_ATOL)
        assert _mpjpe(o, r) <= LIFT_ATOL
    # stage 2: xyz -> aa -> r6d, both packages on the JAX xyz
    r6d_same = t_rot.aa_to_rot6d(t_kin.xyz_to_aa(j_xyz, device="cpu"), device="cpu")
    for o, r in zip(r6d_same, j_r6d):
        np.testing.assert_allclose(o, r, atol=GEOM_ATOL)
    # stage 3: windows + forward, both packages on the JAX windows
    X, _, (mX, sX, _, _) = _windows_and_stats(j_r6d)
    Xs = ((X - mX.transpose(0, 2, 1)) / sX.transpose(0, 2, 1)).astype(np.float32)
    fo, _ = t_infer.run_inference(net, Xs, batch_size=3, device="cpu")
    fr, _ = infer.run_inference(module, variables, Xs, batch_size=3,
                                matmul_precision="float32")
    np.testing.assert_allclose(fo, fr, atol=FWD_ATOL)
    # stage 4: the result pickles of each chain have the same contract
    for name in ("r6d_test.pkl", "aa_test.pkl", "xyz_test.pkl"):
        for res in dirs.values():
            assert os.path.exists(res / f"results_{res.name}" / name)
    assert os.path.exists(tmp_path / "root.pkl") and os.path.exists(tmp_path / "bone_len.pkl")
    assert np.asarray(p_res).shape == np.asarray(j_res).shape == (len(LENGTHS), 192, 150)
    # end to end: the two independent chains
    assert _mpjpe(p_res, j_res) <= MPJPE_BUDGET


def test_run_inference_batching_and_precision_switch(rng):
    """Partial last batch, the num_samples cap and the L1 accounting of
    infer.py:103-118; the TF32 switches are restored afterwards."""
    net = t_registry.build_generator("v1", 12, 8, default_size=16, device="cpu")
    X = rng.randn(10, 32, 12).astype(np.float32)
    Y = rng.randn(10, 32, 8).astype(np.float32)
    module = registry.build_generator("v1", 12, 8, default_size=16)
    variables = jax.tree.map(
        np.asarray, registry.init_generator(module, jax.random.PRNGKey(2), T=32)
    )
    net.load_state_dict(convert.generator_state_dict(variables), strict=True)
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    for n_samples, want in ((3000, 10), (5, 8)):
        ours, err = t_infer.run_inference(net, X, batch_size=4, num_samples=n_samples,
                                          test_Y=Y, matmul_precision="tensorfloat32",
                                          device="cpu")
        ref, rerr = infer.run_inference(module, variables, X, batch_size=4,
                                        num_samples=n_samples, test_Y=Y,
                                        matmul_precision="float32")
        assert ours.shape[0] == ref.shape[0] == want
        np.testing.assert_allclose(ours, ref, atol=FWD_ATOL)
        np.testing.assert_allclose(err, rerr, rtol=1e-5)
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == before


def test_port_clis_match_the_root_inference_cli(tmp_path, monkeypatch, rng):
    """``python -m <port>.lift`` then ``python -m <port>.inference`` on a JAX
    ``.pkl`` checkpoint, against the root (JAX) inference.py on the same
    r6d pickles: same windows, same L1, result xyz within the budget."""
    import inference as root_inference  # the JAX CLI at the repository root

    from multimodal_hand_pose_enhancement_for_sign_language_tpu.train import (
        checkpoint as jax_ckpt,
    )
    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch import (
        inference as t_inference,
        lift as t_lift,
    )

    monkeypatch.chdir(tmp_path)
    data = tmp_path / "data"
    models = tmp_path / "models"
    data.mkdir()
    models.mkdir()
    for split in ("train", "test"):
        save_binary(_clips(rng)[:3], str(data / f"xy_{split}"))
        t_lift.lift_split(str(data), split, n_partitions=2, n_cycles=20, device="cpu")
    X, Y, stats = _windows_and_stats(load_binary(str(data / "r6d_train.pkl")))
    standardize.save_standardization(str(models / "demoarm2wh_preprocess_core.npz"),
                                     *stats)
    module = registry.build_generator("v1", 36, 252)
    variables = registry.init_generator(module, jax.random.PRNGKey(3), T=192)
    ckpt = str(models / "demo_checkpoint.pkl")
    jax_ckpt.save_checkpoint(ckpt, {"epoch": 1, "state": {
        "g_params": variables["params"], "g_stats": variables["batch_stats"]}})

    common = ["--checkpoint", ckpt, "--data_dir", str(data), "--exp_name", "demo",
              "--batch_size", "2"]
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    err_port = t_inference.main(t_inference.build_parser().parse_args(
        common + ["--base_path", str(tmp_path / "port"), "--device", "cpu"]))
    err_jax = root_inference.main(root_inference.build_parser().parse_args(
        common + ["--base_path", str(tmp_path / "jax"), "--seqs_to_viz", "0",
                  "--matmul_precision", "float32"]))
    np.testing.assert_allclose(err_port, err_jax, rtol=1e-4)
    ours = load_binary(str(tmp_path / "port" / "results_demo" / "xyz_test.pkl"))
    ref = load_binary(str(tmp_path / "jax" / "results_demo" / "xyz_test.pkl"))
    assert np.asarray(ours).shape == np.asarray(ref).shape == (3, 192, 150)
    assert _mpjpe(ours, ref) <= MPJPE_BUDGET
