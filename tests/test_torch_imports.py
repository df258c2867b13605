"""The port runs without JAX: no import of jax, flax, optax or the JAX package.

* In a subprocess whose ``sys.modules`` blocks those packages, every port
  module imports, a checkpoint written by the JAX package's own
  ``train.checkpoint.save_checkpoint`` (with an optax Adam state and a typed
  PRNG key inside) loads, and its generator weights load into the port's
  v1 with ``strict=True``, equal to the converter's output in this process.
* Statically, no module of the port, not chip_smoke.py and not
  chip_step_precision.py imports them.
* chip_smoke.py refuses to run (nonzero exit, no result line) on a machine
  without CUDA.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import optax

from multimodal_hand_pose_enhancement_for_sign_language_tpu.models import registry
from multimodal_hand_pose_enhancement_for_sign_language_tpu.train import (
    checkpoint as jax_ckpt,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import convert

ROOT = Path(__file__).resolve().parents[1]
PORT = "multimodal_hand_pose_enhancement_for_sign_language_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax",
           "multimodal_hand_pose_enhancement_for_sign_language_tpu")

_CHILD = r"""
import importlib, json, pkgutil, sys
for name in {blocked!r}:
    sys.modules[name] = None  # any import of these raises ImportError
import numpy as np
import {port} as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for n in names:
    importlib.import_module(n)
from {port}.models import registry
from {port}.train import checkpoint
sd = checkpoint.load_generator_state({ckpt!r})
net = registry.build_generator("v1", 36, 252, default_size=32, device="cpu")
net.load_state_dict(sd, strict=True)
loaded = checkpoint.load_jax_pickle({ckpt!r})
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in {blocked!r} and sys.modules[m] is not None)
np.savez({out!r}, **{{k: v.numpy() for k, v in net.state_dict().items()}})
print(json.dumps({{"modules": names, "epoch": int(loaded["epoch"]), "leaked": leaked,
                  "opt": type(loaded["state"]["g_opt"]).__name__}}))
"""


def _jax_checkpoint(path):
    module = registry.build_generator("v1", 36, 252, default_size=32)
    variables = registry.init_generator(module, jax.random.PRNGKey(0), T=64)
    state = {
        "g_params": variables["params"],
        "g_stats": variables["batch_stats"],
        "g_opt": optax.adam(1e-3).init(variables["params"]),
        "rng": jax.random.key(7),
    }
    jax_ckpt.save_checkpoint(path, {"epoch": 5, "state": state, "config": {"lr": 1e-3}})
    return jax.tree.map(np.asarray, variables)


def test_port_imports_and_loads_a_jax_checkpoint_without_jax(tmp_path):
    ckpt = str(tmp_path / "experiment_checkpoint.pkl")
    variables = _jax_checkpoint(ckpt)
    out = str(tmp_path / "sd.npz")
    code = _CHILD.format(blocked=BLOCKED, port=PORT, ckpt=ckpt, out=out)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    assert info["leaked"] == []
    assert info["epoch"] == 5
    assert f"{PORT}.lifting.engine" in info["modules"]
    assert f"{PORT}.ops.filter_sgd" in info["modules"]
    for name in ("ops.robust_loss", "losses.basic", "losses.robust.adaptive",
                 "losses.robust.distribution", "losses.robust.general",
                 "losses.robust.cubic_spline", "losses.robust.util",
                 "train.gan", "train.data", "train.staging", "train.schedulers",
                 "train.checkpoint", "utils.metrics", "train_gan",
                 "models.classifier", "train.classifier", "train.optim",
                 "data.categories", "data.synthetic", "classifier_main",
                 "classifier_mlp_main"):
        assert f"{PORT}.{name}" in info["modules"], name
    want = convert.generator_state_dict(variables)
    got = np.load(out)
    assert sorted(got.files) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.numpy())


def _imported_modules(path):
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.append(node.args[0].value)
    return names


def test_no_port_file_imports_jax_or_the_jax_package():
    files = sorted((ROOT / PORT).rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "chip_step_precision.py"]
    assert len(files) > 40
    for f in files:
        for name in _imported_modules(f):
            assert name.split(".")[0] not in BLOCKED, f"{f} imports {name}"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
