"""The port's small utilities against the JAX package's.

* ``utils/nan_guard``: ``tree_check_finite`` gives the JAX function's report
  (names and counts) on the same nested numpy tree, and reports a module's
  ``state_dict``, its gradients and an optimizer's state by the same rule;
  ``assert_finite`` takes tensors and raises the JAX function's message;
  ``enable_debug_nans`` switches PyTorch's anomaly mode.
* ``utils/profiling``: ``StepTimer`` equals the JAX one under the same
  patched clock; ``trace`` writes a Chrome trace holding an ``annotate``
  region, ``trace(None)`` writes nothing.
* ``utils/platform``: ``host_fingerprint`` equals the JAX one on this host;
  ``toolchain_fingerprint`` holds ``nvcc --version`` and the host
  compiler's version line; ``ops/build.library``'s digest changes with the
  toolchain's text.
"""

import json
import os
import sys
import time
from collections import OrderedDict

import numpy as np
import pytest
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu.utils import (
    nan_guard as j_nan,
    platform as j_platform,
    profiling as j_prof,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import build
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils import (
    nan_guard,
    platform,
    profiling,
)


def _tree(rng):
    a = rng.randn(3, 4).astype(np.float32)
    a[1, 2] = np.nan
    b = rng.randn(5).astype(np.float32)
    b[[0, 4]] = np.inf
    c = rng.randn(2, 2)
    c[0, 0] = -np.inf
    return {
        "params": {"conv": {"kernel": a, "bias": np.zeros(4, np.float32)},
                   "dense": [b, (c, None), np.ones(2)]},
        "state": OrderedDict([("w", np.array([np.nan, 1.0, np.nan])), ("v", np.ones(3))]),
        "step": {0: np.array(3), 1: np.array(np.nan)},
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_tree_check_finite_matches_jax(seed):
    tree = _tree(np.random.RandomState(seed))
    want = j_nan.tree_check_finite(tree)
    assert want == {"params/conv/kernel": 1, "params/dense/[0]": 2,
                    "params/dense/[1]/[0]": 1, "state/w": 2, "step/1": 1}
    assert nan_guard.tree_check_finite(tree) == want
    torch_tree = _map(tree, lambda a: torch.from_numpy(np.asarray(a)))
    assert nan_guard.tree_check_finite(torch_tree) == want
    assert nan_guard.tree_check_finite(_map(tree, lambda a: np.nan_to_num(a))) == {}


def _map(tree, fn):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, _map(v, fn)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def test_tree_check_finite_on_a_modules_state_and_gradients():
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    opt = torch.optim.Adam(net.parameters())
    net(torch.randn(5, 3)).sum().backward()
    opt.step()
    grads = {k: p.grad for k, p in net.named_parameters()}
    assert nan_guard.tree_check_finite(net.state_dict()) == {}
    assert nan_guard.tree_check_finite(grads) == {}
    assert nan_guard.tree_check_finite(opt.state_dict()) == {}
    grads["0.weight"][1, 2] = float("nan")
    net[1].running_var[0] = float("inf")
    assert nan_guard.tree_check_finite(grads) == {"0.weight": 1}
    assert nan_guard.tree_check_finite(net.state_dict()) == {"1.running_var": 1}
    assert j_nan.tree_check_finite(
        {k: v.numpy() for k, v in grads.items()}) == {"0.weight": 1}


def test_assert_finite_takes_tensors():
    nan_guard.assert_finite("ok", torch.ones(3), np.zeros(2), torch.ones(2, dtype=torch.bfloat16))
    bad = torch.tensor([1.0, float("nan"), float("inf")])
    with pytest.raises(AssertionError) as got:
        nan_guard.assert_finite("x", torch.ones(1), bad)
    with pytest.raises(AssertionError) as want:
        j_nan.assert_finite("x", np.ones(1), bad.numpy())
    assert str(got.value) == str(want.value) == "x[1]: 2/3 non-finite values"


def test_enable_debug_nans_switches_anomaly_mode():
    before = torch.is_anomaly_enabled()
    try:
        nan_guard.enable_debug_nans(True)
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()  # NaN made in the forward, raised in backward
        nan_guard.enable_debug_nans(False)
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(before)


@pytest.mark.parametrize("warmup,ticks", [(1, [0.0, 0.5, 0.75, 1.5, 1.625]), (0, [2.0, 3.0]),
                                          (3, [0.0, 1.0])])
def test_step_timer_matches_jax(monkeypatch, warmup, ticks):
    out = []
    for module in (j_prof, profiling):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        timer = module.StepTimer(warmup=warmup)
        for _ in ticks:
            timer.tick()
        out.append((timer.summary(), timer.mean))
    assert out[0] == out[1]


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)) as prof:
        with profiling.annotate("port_region"):
            torch.ones(8).mul(2).sum()
    assert prof is not None
    (path,) = log_dir.iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "port_region" for e in events)


def test_trace_none_writes_nothing(tmp_path):
    before = set(os.listdir(tmp_path))
    with profiling.trace(None) as prof:
        with profiling.annotate("unused"):
            torch.ones(2).sum()
    assert prof is None
    assert set(os.listdir(tmp_path)) == before


def test_host_fingerprint_matches_jax():
    fp = platform.host_fingerprint()
    assert fp == j_platform.host_fingerprint()
    assert len(fp) == 10


def _stand_in(tmp_path, name, line):
    tool = tmp_path / name
    tool.write_text(f"#!{sys.executable}\nprint({line!r})\n")
    tool.chmod(0o755)
    return str(tool)


def _stand_in_nvcc(tmp_path, release):
    return _stand_in(tmp_path, f"nvcc{release}", f"Cuda compilation tools, release {release}")


def test_toolchain_fingerprint_holds_nvcc_and_the_host_compiler(tmp_path):
    gxx = _stand_in(tmp_path, "g++13", "g++ (stand-in) 13.3.0")
    text = platform.toolchain_fingerprint(_stand_in_nvcc(tmp_path, "12.9"), gxx)
    assert "Cuda compilation tools, release 12.9 (exit 0)" in text
    assert f"host compiler {gxx}: g++ (stand-in) 13.3.0 (exit 0)" in text
    assert platform.toolchain_fingerprint(_stand_in_nvcc(tmp_path, "12.8"), gxx) != text
    other_gxx = _stand_in(tmp_path, "g++12", "g++ (stand-in) 12.3.0")
    assert platform.toolchain_fingerprint(_stand_in_nvcc(tmp_path, "12.9"), other_gxx) != text
    missing = platform.toolchain_fingerprint(str(tmp_path / "no_nvcc"), gxx)
    assert "no_nvcc" in missing  # a missing nvcc is its own key, not an error here


def test_library_digest_follows_the_toolchain(tmp_path, monkeypatch):
    tools = {"nvcc": _stand_in_nvcc(tmp_path, "12.9"),
             "g++": _stand_in(tmp_path, "g++13", "g++ (stand-in) 13.3.0")}
    monkeypatch.setattr(build, "_tool", lambda name: tools[name])
    first = build.library("filter_sgd")
    assert build.library("filter_sgd") == first
    tools["nvcc"] = _stand_in_nvcc(tmp_path, "12.8")
    second = build.library("filter_sgd")
    assert second != first
    tools["g++"] = _stand_in(tmp_path, "g++12", "g++ (stand-in) 12.3.0")
    assert build.library("filter_sgd") not in (first, second)
    monkeypatch.setattr(platform, "toolchain_fingerprint", lambda nvcc, host: "another")
    other = build.library("filter_sgd")
    assert other not in (first, build.library("robust_loss"))
    assert other.parent == first.parent and other.name.startswith("libfilter_sgd-")


def test_nvcc_is_given_the_fingerprinted_host_compiler(tmp_path, monkeypatch):
    """The host compiler in the library's key is the one nvcc is told to
    call (``-ccbin``), not whichever nvcc would pick by itself."""
    tools = {"nvcc": _stand_in_nvcc(tmp_path, "12.9"),
             "g++": _stand_in(tmp_path, "g++13", "g++ (stand-in) 13.3.0")}
    monkeypatch.setattr(build, "_tool", lambda name: tools[name])
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    seen = {}

    def popen(cmd, **kwargs):
        seen["cmd"] = cmd
        raise OSError("stand-in: not run")

    monkeypatch.setattr(build.subprocess, "Popen", popen)
    with pytest.raises(OSError):
        build.build("filter_sgd")
    cmd = seen["cmd"]
    assert cmd[0] == tools["nvcc"]
    assert cmd[cmd.index("-ccbin") + 1] == tools["g++"]
    assert tools["g++"] in platform.toolchain_fingerprint(tools["nvcc"], tools["g++"])
