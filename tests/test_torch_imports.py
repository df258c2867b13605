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
* The featurizers and the demo need none of what the card's machine lacks:
  with ``transformers``, ``tokenizers``, ``safetensors``, ``regex``,
  ``torchvision``, ``clip``, ``cv2``, PIL, ``matplotlib`` and ``h5py``
  blocked too, every port module imports, the three text methods and both
  image features run from snapshots the port writes itself, and the demo
  runs its synthetic sequence; statically, those packages are imported
  only inside functions (the hub routes, video decoding, the grad-flow
  plot, an .h5 input).
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
                 "classifier_mlp_main", "data.openpose", "data.text", "data.video",
                 "data.datasets", "data.skeleton_preproc", "runtime.native",
                 "process_dataset", "article_replay", "data.tokenizers",
                 "models.hf_snapshot", "models.text_encoders", "models.clip_vision",
                 "models.resnet", "demo", "viz.track_grads",
                 "losses.robust.fit_partition_spline", "parallel.mesh", "parallel.batchnorm",
                 "parallel.multihost", "parallel.sequence"):
        assert f"{PORT}.{name}" in info["modules"], name
    want = convert.generator_state_dict(variables)
    got = np.load(out)
    assert sorted(got.files) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.numpy())


# absent on the card's machine: imported only inside the functions that need them
CARD_ABSENT = ("transformers", "tokenizers", "safetensors", "regex", "torchvision", "clip",
               "cv2", "PIL", "matplotlib", "h5py")

_FEATURIZER_CHILD = r"""
import importlib, json, pkgutil, sys
for name in {blocked!r}:
    sys.modules[name] = None
import numpy as np
import {port} as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
from {port}.data import synthetic, text, video
d = {tmp!r}
S = ["hello world, sign language!", "the cat's hat is red"]
open(d + "/t.txt", "w").write("".join(f"c{{i}}-x {{s}}\n" for i, s in enumerate(S)))
synthetic.write_bert_snapshot(d + "/bert", S, hidden_size=16, num_layers=1, num_heads=2,
                              intermediate_size=32)
synthetic.write_clip_snapshot(d + "/clip", S, projection_dim=8,
    text=dict(hidden_size=64, num_hidden_layers=1, num_attention_heads=1, intermediate_size=32),
    vision=dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=32, image_size=32, patch_size=16))
shapes = {{m: text.obtain_embeddings(d + "/t.txt", ["c0-x", "c1-x"], method=m,
                                    weights_path=d + ("/clip" if m == "clip" else "/bert"),
                                    device="cpu").shape
          for m in ("BERTsentence", "BERTword", "clip")}}
crops = [np.zeros((2, 3, 120, 120, 2), np.uint8)]
shapes["resnet"] = video.obtain_feats_crops_resnet(crops, None, device="cpu")[0].shape
shapes["clip_image"] = video.obtain_feats_crops_clip(crops, d + "/clip", device="cpu")[0].shape
from {port} import demo
shapes["demo"] = demo.main(demo.build_parser().parse_args(
    ["--out_dir", d + "/demo", "--n_cycles", "5", "--device", "cpu"]))[0].shape
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in {blocked!r} and sys.modules[m] is not None)
print(json.dumps({{"shapes": shapes, "leaked": leaked}}))
"""


def test_featurizers_run_without_the_hub_packages(tmp_path):
    code = _FEATURIZER_CHILD.format(blocked=BLOCKED + CARD_ABSENT, port=PORT, tmp=str(tmp_path))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    assert info["leaked"] == []
    assert info["shapes"] == {"BERTsentence": [2, 16], "BERTword": [2, 512, 16],
                              "clip": [2, 8], "resnet": [2, 2000], "clip_image": [2, 16],
                              "demo": [64, 50]}


def _top_level_imports(path):
    """Modules imported outside any function body."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    names = []

    def visit(node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(tree)
    return names


def test_hub_packages_are_imported_only_inside_functions():
    files = sorted((ROOT / PORT).rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for name in _top_level_imports(f):
            assert name.split(".")[0] not in CARD_ABSENT, f"{f} imports {name} at import time"


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
