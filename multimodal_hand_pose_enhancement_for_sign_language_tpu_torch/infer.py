"""Inference: batched enhancement forward + result pickles.

PyTorch counterpart of the JAX package's ``infer.py``:
  * ``run_inference`` -- the reference inference.py:90-126: eval-mode
    batched forward with L1 accounting, the partial final batch and the
    ``num_samples`` cap; with a ``mesh``, batches sharded over its ranks
    (the JAX package's replacement for nn.DataParallel, inference.py:45-47),
  * ``save_results`` -- utils/utils.py:388-427: r6d/aa/xyz pickles
    (+ root.pkl / bone_len.pkl in the working directory) with the same file
    contract, through the batched geometry ops.
"""

from __future__ import annotations

import copy
import os
import pickle
from contextlib import contextmanager

import numpy as np
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import (
    windows as win_lib,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.io import (
    load_binary,
    mkdir,
    save_binary,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models.registry import (
    needs_feats,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import (
    kinematics,
    rotations,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.parallel import (
    mesh as mesh_lib,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.constants import (
    FEATURE_MAP,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.device import (
    resolve_device,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.profiling import span

_TF32 = {"float32": False, "tensorfloat32": True}


@contextmanager
def conv_matmul_precision(matmul_precision: str):
    """Set cuDNN's and cuBLAS's TF32 switches for the block, then restore.

    cuDNN runs float32 convolutions in TF32 by default (10-bit mantissa);
    'float32' turns that off, 'tensorfloat32' turns TF32 on for both."""
    if matmul_precision not in _TF32:
        raise ValueError(
            f"matmul_precision {matmul_precision!r}: expected one of {sorted(_TF32)}"
        )
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = _TF32[matmul_precision]
    torch.backends.cuda.matmul.allow_tf32 = _TF32[matmul_precision]
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def run_inference(model, test_X, test_feats=None, batch_size: int = 128,
                  num_samples: int = 3000, test_Y=None,
                  matmul_precision: str = "float32", device="cuda", bf16: bool = False,
                  mesh=None):
    """Eval-mode batched forward over (N, T, D) numpy inputs.

    ``model`` is a generator taking (B, D, T).  A conditioned one takes
    ``test_feats`` too, row for row with ``test_X``: text (N, 512) per clip
    or image features (N, T, 2000) per frame.  Returns (output (M, T, Dout)
    numpy, mean L1 error vs ``test_Y`` or None).  Batches follow the
    reference: the last one may be partial, and the loop stops at the first
    batch boundary past ``num_samples``.  ``matmul_precision`` is 'float32'
    (the default: TF32 off for convs and matmuls) or 'tensorfloat32'.
    ``bf16`` runs the forward in bfloat16, as the JAX package's ``bf16``: a
    copy of the model with its floating weights and running statistics in
    bfloat16, the inputs cast to it, the outputs cast back to float32.
    ``mesh`` (``parallel/mesh.get_mesh``; every rank calls with the same
    inputs): a batch whose rows divide 'data' is split, each rank runs its
    rows and the outputs are all-gathered; the others (the partial last
    batch) run whole on every rank.  Every rank returns the whole output.
    With the tracer on (``utils/profiling``) the call is the span
    ``infer.run``, and each batch's copy in, forward and copy out the spans
    ``infer.h2d``, ``infer.forward`` and ``infer.d2h``.
    """
    with span("infer.run"):
        if needs_feats(model) and test_feats is None:
            raise ValueError("the model is conditioned on features: pass test_feats")
        dev = resolve_device(device)
        if mesh is not None:
            mesh.check_device(dev)
        model = model.to(dev).eval()
        dtype = torch.float32
        if bf16:
            dtype = torch.bfloat16
            model = copy.deepcopy(model).to(dtype)  # the caller's model stays float32
        outputs = []
        error = 0.0
        total_steps = 0
        n = min(test_X.shape[0], num_samples)
        with torch.no_grad(), conv_matmul_precision(matmul_precision):
            for start in range(0, n, batch_size):
                end = min(start + batch_size, test_X.shape[0])
                with span("infer.h2d"):
                    x = torch.from_numpy(np.ascontiguousarray(test_X[start:end])).to(dev, dtype)
                    f = None
                    if test_feats is not None:
                        f = torch.from_numpy(np.ascontiguousarray(test_feats[start:end])).to(
                            dev, dtype)
                with span("infer.forward"):
                    if mesh is not None and x.shape[0] % mesh.shape["data"] == 0:
                        x, f = mesh_lib.local_rows((x, f), mesh)[0]
                        y = model(x.transpose(1, 2), f).transpose(1, 2)
                        y = mesh_lib.gather_rows(y, mesh.data_group, mesh.shape["data"])
                    else:
                        y = model(x.transpose(1, 2), f).transpose(1, 2)
                with span("infer.d2h"):
                    y = y.float().cpu().numpy()
                outputs.append(y)
                total_steps += 1
                if test_Y is not None:
                    error += float(np.mean(np.abs(y - test_Y[start:end]))) * batch_size
        output = np.concatenate(outputs, axis=0)
        mean_err = error / max(total_steps * batch_size, 1) if test_Y is not None else None
        return output, mean_err


# save_results derives root/bone_len from the FULL train xyz pickle on every
# call (utils/utils.py:400-410 recomputes them per invocation); that is a
# pure function of the file, so one memo entry keyed by (path, mtime, size)
# lets repeated calls skip the reload.  The root.pkl/bone_len.pkl files are
# still written on every call.
_ROOT_BONE_CACHE: dict = {}


def _train_root_bone(data_dir):
    path = os.path.abspath(os.path.join(data_dir, "xyz_train.pkl"))
    st = os.stat(path)
    key = (path, st.st_mtime_ns, st.st_size)
    if key not in _ROOT_BONE_CACHE:
        xyz_train = load_binary(path)
        xyz_train = win_lib.make_equal_len(xyz_train, method="cutting+reflect")
        xyz_train, _, _ = win_lib.rmv_clips_nan(xyz_train)
        root = kinematics.get_root_bone(xyz_train)
        bone_len = kinematics.get_bone_length(xyz_train)
        if np.any(np.isnan(root)) or np.any(np.isnan(bone_len)):
            raise ValueError(f"{path}: root or bone lengths are NaN")
        _ROOT_BONE_CACHE.clear()  # at most one entry; values are tiny
        _ROOT_BONE_CACHE[key] = (root, bone_len)
    return _ROOT_BONE_CACHE[key]


def _check_finite(name, a):
    if np.any(np.isnan(a)):
        raise ValueError(f"save_results: {name} contains NaN")


def save_results(input_windows, output_windows, pipeline: str, base_path: str,
                 data_dir: str, tag: str = "", infer_set: str = "",
                 device="cuda"):
    """Write r6d/aa/xyz pickles for enhanced sequences; returns the xyz
    pickle's path (None for a pipeline without hand output).

    ``input_windows``/``output_windows`` are (N, T, D) r6d arrays at the
    original scale.  File contract of utils/utils.py:388-427."""
    dev = resolve_device(device)
    out_feat = pipeline.split("2")[1]
    res_dir = f"results_{tag}/"
    mkdir(os.path.join(base_path, res_dir))
    _check_finite("input_windows", input_windows)
    _check_finite("output_windows", output_windows)
    if not (pipeline in FEATURE_MAP or out_feat in ("wh", "fingerL")):
        return None

    if pipeline in ("arm_wh2wh", "wh2wh"):
        input_windows = input_windows[:, :, : 6 * 6]  # keep arms

    filename = os.path.join(base_path, f"{res_dir}/r6d_{infer_set}")
    save_binary(np.concatenate((input_windows, output_windows), axis=2), filename)

    input_aa = np.array(rotations.rot6d_to_aa(input_windows, device=dev))
    output_aa = np.array(rotations.rot6d_to_aa(output_windows, device=dev))
    _check_finite("input aa", input_aa)
    _check_finite("output aa", output_aa)
    filename = os.path.join(base_path, f"{res_dir}/aa_{infer_set}")
    save_binary(np.concatenate((input_aa, output_aa), axis=2), filename)

    root, bone_len = _train_root_bone(data_dir)
    with open("root.pkl", "wb") as handle:
        pickle.dump(root, handle, protocol=pickle.HIGHEST_PROTOCOL)
    with open("bone_len.pkl", "wb") as handle:
        pickle.dump(bone_len, handle, protocol=pickle.HIGHEST_PROTOCOL)

    input_output_aa = load_binary(
        os.path.join(base_path, f"{res_dir}/aa_{infer_set}.pkl")
    )
    _check_finite("aa pickle", input_output_aa)
    input_output_xyz = kinematics.aa_to_xyz(input_output_aa, root, bone_len, device=dev)
    _check_finite("xyz", input_output_xyz)
    filename = os.path.join(base_path, f"{res_dir}/xyz_{infer_set}")
    save_binary(input_output_xyz, filename)
    return filename + ".pkl"
