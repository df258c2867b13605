"""The port's multi-device layer on gloo CPU ranks, against the JAX package.

Ranks are processes spawned with ``torch.multiprocessing`` over a gloo
group (a ``file://`` rendezvous in the test's own directory, one torch
thread each); this module's top level imports no JAX, because the children
import it.  The JAX references run in the parent, on its virtual CPU
devices, while the children work.  One spawn of 2 ranks (mesh 2 x 1) and
one of 4 (2 x 2, tensor-parallel) run every check; the tests read their
results.  Sizes as tests/test_torch_gan.py: T=32, 12 -> 24, default_size
32, B=8, the JAX trainer's initial state (BatchNorm statistics perturbed)
carried into the port by ``models/convert``.

Tolerances:
  * the G, D and val steps (2 ranks, dropout 0; 4 ranks with ``tp``)
    against the port's single-device step, JAX's single-device step and
    JAX's 2-device DP step: the port's step tolerances (ROADMAP header):
    loss 1e-5 relative, running statistics 5e-6, parameters 5e-6 outside
    the sign-noise mask of tests/test_torch_gan.py (0 < |g| < 1e-6, such an
    entry within 2 lr + 5e-6, at most 1e-3 of the entries); JAX's TP step
    1e-3 on the loss (tests/test_multichip.py:210),
  * dropout 0.5, against the port's single-device step: loss 1e-4
    (tests/test_multichip.py:42); a 2-rank epoch: 1e-3 (:58),
  * a batch of 5 rows on 2 ranks (replicated): running statistics equal to
    the single-device step's, bit for bit,
  * the classifier's DP step (bidirectional, remat, dropout 0) against
    JAX's 2-device step: loss 1e-5, accuracy equal, parameters 1e-5
    (tests/test_multichip.py:104-107),
  * sharded ``run_inference`` against the port's single device 1e-6, JAX
    2e-4; sharded ``lift_clips`` against unsharded 1e-6, JAX's 'xla' path
    2e-4 (z 2e-3, tests/test_torch_lifting.py),
  * ``filter_xyz_time_sharded`` on 2 and 4 ranks against JAX's
    ``filter_xyz`` and JAX's time-sharded filter on 4 devices: 2e-4
    (tests/test_sequence_parallel.py:33); T=1920 on 4 ranks against the
    port's plain filter: 2e-4,
  * ``train_gan`` under ``torch.distributed.run --nproc_per_node=2`` for
    one epoch against one process: losses 1e-5 relative, checkpoint
    tensors 5e-6 but for at most 1e-3 of the entries (Adam's sign flips),
    which stay within 2 lr per step.
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import synthetic
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.io import load_binary
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.lifting import (
    engine as t_engine,
    filtering as t_filtering,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import (
    classifier as t_cls_models,
    convert,
    registry as t_registry,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch import infer as t_infer
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.parallel import (
    mesh as mesh_lib,
    multihost,
    sequence,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train import (
    checkpoint as t_ckpt,
    classifier as t_cls,
    gan as t_gan,
)

ROOT = Path(__file__).resolve().parents[1]
PORT = "multimodal_hand_pose_enhancement_for_sign_language_tpu_torch"
B, T, DIN, DOUT, SIZE = 8, 32, 12, 24, 32
LR = 1e-4
STEP_RTOL = 1e-5
STEP_ATOL = 5e-6
NOISE = 1e-6
MASKED_SHARE = 1e-3
DROPOUT_ATOL = 1e-4
EPOCH_ATOL = 1e-3
TP_JAX_ATOL = 1e-3
CLS_ATOL = 1e-5
INFER_SELF_ATOL = 1e-6
INFER_JAX_ATOL = 2e-4
LIFT_SELF_ATOL = 1e-6
LIFT_ATOL, LIFT_Z_ATOL = 2e-4, 2e-3
FILTER_ATOL = 2e-4
CLS_LR = 1e-3


# ----------------------------------------------------------------------
# inputs, made alike in the parent and the children
# ----------------------------------------------------------------------
def _cfg(dropout=0.0, **over):
    return t_gan.GanConfig(
        feature_in_dim=DIN, feature_out_dim=DOUT, default_size=SIZE, window_t=T,
        batch_size=B, loss="RobustLoss", learning_rate=LR, dropout_rate=dropout,
        disc_label_smooth=True, **over)


def _batch(n=B, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, T, DIN).astype(np.float32), rng.randn(n, T, DOUT).astype(np.float32))


def _clips():
    rng = np.random.RandomState(5)
    kp = rng.uniform(100, 500, size=(30, 150)).astype(np.float32)
    kp[:, 2::3] = rng.uniform(0.5, 1.0, size=(30, 50))
    return [kp, kp[:20], kp[:25]]


def _filter_inputs(T_, seed):
    rng = np.random.RandomState(seed)
    x0, y0, z0, tarx, tary = (rng.randn(T_, 50).astype(np.float32) for _ in range(5))
    return x0, y0, z0, tarx, tary, rng.rand(T_, 50).astype(np.float32)


def _cls_data():
    rng = np.random.RandomState(9)
    return rng.randn(8, 16, 12).astype(np.float32), rng.randint(0, 10, size=8)


def _trainer(state, dropout=0.0, mesh=None, tp=False, **over):
    tr = t_gan.GanTrainer(_cfg(dropout, **over), device="cpu", mesh=mesh, tp=tp)
    if state is not None:
        g_sd = state["g"]
        if tr.tp:
            g_sd = mesh_lib.tp_local_state_dict(g_sd, tr.generator, mesh)
        tr.generator.load_state_dict(g_sd, strict=True)
        tr.discriminator.load_state_dict(state["d"], strict=True)
        tr.adaptive.load_state_dict(state["robust"], strict=True)
    return tr


def _grads(tr, module):
    """{name: whole gradient} of a module after a step (split weights
    gathered)."""
    out = {}
    for name, p in module.named_parameters():
        if p.grad is None:
            continue
        owner = module.get_submodule(name.rsplit(".", 1)[0])
        g = p.grad
        if hasattr(owner, "tp_dim") and name.endswith("weight"):
            g = mesh_lib.gather_split(g, owner.tp_dim, tr.mesh)
        out[name] = g.clone()
    return out


def _steps(state, mesh, tp=False):
    """One G, one D and one val step, each on a fresh trainer."""
    x, y = (torch.from_numpy(a) for a in _batch())
    out = {}
    tr = _trainer(state, mesh=mesh, tp=tp)
    out["g_loss"] = float(tr.g_step(x, y))
    out["g_sd"] = tr.checkpoint_payload(0)["state_dict"]
    out["g_grads"] = _grads(tr, tr.generator)
    out["g_local_shapes"] = {n: tuple(p.shape) for n, p in tr.generator.named_parameters()}
    tr = _trainer(state, mesh=mesh, tp=tp)
    out["d_loss"] = float(tr.d_step(x, y))
    out["d_sd"] = tr.discriminator.state_dict()
    out["d_grads"] = _grads(tr, tr.discriminator)
    tr = _trainer(state, mesh=mesh, tp=tp)
    out["val_loss"] = float(tr.val_step(x, y))
    return out


def _single_steps(state):
    return _steps(state, None)


# ----------------------------------------------------------------------
# what the ranks do
# ----------------------------------------------------------------------
def _entry(rank, world, init, out_dir, job, inputs_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    try:
        inputs = torch.load(inputs_path, weights_only=False)
        res = job(inputs, out_dir)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _job2(inputs, out_dir):
    """Every 2-rank check (mesh 2 x 1)."""
    mesh = mesh_lib.get_mesh()
    state = inputs["state"]
    res = {"steps": _steps(state, mesh)}

    # the same G step from each rank's own rows (multihost)
    x, y = _batch()
    rows = multihost.local_batch_slice(B)
    res["slice"] = (rows.start, rows.stop)
    tr = _trainer(state, mesh=mesh)
    res["gba_loss"] = float(tr.g_step(multihost.global_batch_array(x[rows], mesh),
                                      multihost.global_batch_array(y[rows], mesh)))
    res["gba_g_sd"] = tr.generator.state_dict()

    # dropout 0.5: the masks of the global batch
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    tr = _trainer(None, dropout=0.5, mesh=mesh)
    res["drop_g"] = float(tr.g_step(xt, yt))
    res["drop_d"] = float(tr.d_step(xt, yt))
    res["drop_g_sd"] = tr.generator.state_dict()

    # the options: fused_d's D step, a bfloat16 G step
    tr = _trainer(state, mesh=mesh, fused_d=True)
    res["fused_d"] = (float(tr.d_step(xt, yt)), tr.discriminator.state_dict(),
                      _grads(tr, tr.discriminator))
    res["bf16_g"] = float(_trainer(state, mesh=mesh, compute_dtype="bfloat16").g_step(xt, yt))

    # a 2-rank epoch, from the host and staged
    X, Y = _batch(16, seed=4)
    res["epoch"] = _trainer(None, dropout=0.5, mesh=mesh).run_epoch(X, Y, "g", B)
    tr = _trainer(None, dropout=0.5, mesh=mesh)
    res["epoch_resident"] = tr.run_epoch_resident(*tr.stage(X, Y), np.arange(16), "g", B)

    # a batch that does not divide: replicated, local statistics
    tr = _trainer(state, mesh=mesh)
    tr.g_step(xt[:5], yt[:5])
    res["odd_g_sd"] = tr.generator.state_dict()

    # the classifier's DP step
    X8, labels = _cls_data()
    net = _lstm(inputs["cls_params"])
    ct = t_cls.ClassifierTrainer(net, learning_rate=CLS_LR, mesh=mesh)
    loss, acc = ct.train_step(torch.from_numpy(X8), torch.from_numpy(labels))
    res["cls"] = (float(loss), int(acc), net.state_dict())

    # sharded inference: batches of 4, 4 and 1 (the last replicated)
    res["infer"] = t_infer.run_inference(_generator(state), inputs["infer_X"], batch_size=4,
                                         num_samples=100, device="cpu", mesh=mesh)[0]

    # sharded lifting, and the partitioned file only rank 0 writes
    res["lift"] = t_engine.lift_clips(_clips(), n_cycles=15, device="cpu", mesh=mesh)
    path = os.path.join(out_dir, "xyz_lift.pkl")
    res["lift_file"] = t_engine.lift_2d_to_3d(_clips(), path, nPartitions=2, n_cycles=15,
                                              device="cpu", mesh=mesh)

    res["filter64"] = [a.numpy() for a in sequence.filter_xyz_time_sharded(
        *_filter_inputs(64, 1), mesh, n_cycles=50)]
    return res


def _job4(inputs, out_dir):
    """Every 4-rank check (mesh 2 x 2)."""
    mesh = mesh_lib.get_mesh(model_axis=2)
    res = {"steps": _steps(inputs["state"], mesh, tp=True)}

    # the TP G step from each rank's rows of its data index (multihost)
    x, y = _batch()
    rows = multihost.local_batch_slice(B, mesh)
    res["slice"] = (rows.start, rows.stop)
    tr = _trainer(inputs["state"], mesh=mesh, tp=True)
    res["gba_loss"] = float(tr.g_step(multihost.global_batch_array(x[rows], mesh),
                                      multihost.global_batch_array(y[rows], mesh)))
    res["gba_g_sd"] = tr.checkpoint_payload(0)["state_dict"]
    res["gba_g_grads"] = _grads(tr, tr.generator)
    res["filter64"] = [a.numpy() for a in sequence.filter_xyz_time_sharded(
        *_filter_inputs(64, 1), mesh, n_cycles=50)]
    res["filter1920"] = [a.numpy() for a in sequence.filter_xyz_time_sharded(
        *_filter_inputs(1920, 2), mesh, n_cycles=10)]
    return res


def _lstm(params):
    net = t_cls_models.build_classifier("lstm", device="cpu", input_size=12, hidden_size=8,
                                        num_layers=2, bidirectional=True, remat=True)
    net.load_state_dict(convert.classifier_state_dict(params), strict=True)
    return net


def _generator(state):
    net = t_registry.build_generator("v1", DIN, DOUT, default_size=SIZE, device="cpu")
    net.load_state_dict(state["g"], strict=True)
    return net


def _start(job, world, inputs, tmp):
    """Spawn ``world`` ranks running ``job`` on ``inputs``; returns a join
    function giving each rank's result."""
    tmp.mkdir(parents=True, exist_ok=True)
    inputs_path = str(tmp / "inputs.pt")
    torch.save(inputs, inputs_path)
    ctx = mp.start_processes(_entry, args=(world, str(tmp / "rendezvous"), str(tmp), job,
                                           inputs_path),
                             nprocs=world, join=False, start_method="spawn")

    def join():
        while not ctx.join():
            pass
        return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]

    return join


# ----------------------------------------------------------------------
# the parent: JAX references while the ranks run
# ----------------------------------------------------------------------
def _jax_state():
    import jax

    from multimodal_hand_pose_enhancement_for_sign_language_tpu.train import gan as j_gan

    rng = np.random.RandomState(7)
    jt = j_gan.GanTrainer(j_gan.GanConfig(
        feature_in_dim=DIN, feature_out_dim=DOUT, default_size=SIZE, window_t=T,
        batch_size=B, loss="RobustLoss", learning_rate=LR, dropout_rate=0.0,
        disc_label_smooth=True))
    state = jt.init_state()

    def perturb(path, a):
        a = np.asarray(a)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (0.1 * rng.randn(*a.shape)).astype(np.float32)

    for k in ("g_stats", "d_stats"):
        state[k] = jax.tree_util.tree_map_with_path(perturb, state[k])
    state.pop("rng")
    return jt, jax.tree.map(np.asarray, state)


def _port_state(s):
    return {"g": convert.generator_state_dict({"params": s["g_params"],
                                               "batch_stats": s["g_stats"]}),
            "d": convert.discriminator_state_dict({"params": s["d_params"],
                                                   "batch_stats": s["d_stats"]}),
            "robust": convert.robust_state_dict(s["robust"])}


def _jax_steps(jt, state0, mesh=None, tp=False):
    """JAX's G, D and val steps on the test batch: (losses, G and D state
    dicts in the port's layout), on one device or sharded over ``mesh``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from multimodal_hand_pose_enhancement_for_sign_language_tpu.parallel import (
        mesh as j_mesh,
    )
    from multimodal_hand_pose_enhancement_for_sign_language_tpu.train import gan as j_gan

    if mesh is not None:
        jt = j_gan.GanTrainer(jt.cfg, mesh=mesh, tp=tp)
    x, y = _batch()

    def fresh():
        st = jax.tree.map(jnp.asarray, state0)
        st["rng"] = jax.random.key(0, impl=jt.cfg.prng_impl)
        if mesh is None:
            return st, jnp.asarray(x), jnp.asarray(y)
        st = j_mesh.replicate(st, mesh)
        if tp:
            st["g_params"] = j_mesh.tp_param_placement(st["g_params"], mesh)
            st["g_opt"] = jt.g_tx.init(st["g_params"])
        sh = NamedSharding(mesh, P("data"))
        return st, jax.device_put(x, sh), jax.device_put(y, sh)

    out = {}
    st, loss = jt._g_step(*fresh(), None)
    out["g_loss"] = float(loss)
    out["g_sd"] = convert.generator_state_dict(jax.tree.map(
        np.asarray, {"params": st["g_params"], "batch_stats": st["g_stats"]}))
    st, loss = jt._d_step(*fresh(), None)
    out["d_loss"] = float(loss)
    out["d_sd"] = convert.discriminator_state_dict(jax.tree.map(
        np.asarray, {"params": st["d_params"], "batch_stats": st["d_stats"]}))
    out["val_loss"] = float(jt._val_step(*fresh(), None))
    return out


def _jax_classifier(params, mesh):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from multimodal_hand_pose_enhancement_for_sign_language_tpu.models.classifier import (
        ClassifLSTM,
    )
    from multimodal_hand_pose_enhancement_for_sign_language_tpu.train.classifier import (
        ClassifierTrainer,
    )

    X, labels = _cls_data()
    m = ClassifLSTM(hidden_size=8, num_layers=2, num_classes=10, bidirectional=True,
                    remat=True, dropout=0.0)
    tr = ClassifierTrainer(m, learning_rate=CLS_LR)
    p = jax.device_put(jax.tree.map(jnp.asarray, params), NamedSharding(mesh, P()))
    sh = NamedSharding(mesh, P("data"))
    p1, _, loss, acc = tr._train_step(p, tr.tx.init(p), jax.device_put(X, sh),
                                      jax.device_put(labels.astype(np.int32), sh),
                                      jax.random.PRNGKey(3))
    return float(loss), int(acc), convert.classifier_state_dict(jax.tree.map(np.asarray, p1))


def _cls_params():
    import jax

    from multimodal_hand_pose_enhancement_for_sign_language_tpu.models.classifier import (
        ClassifLSTM,
    )

    X, _ = _cls_data()
    m = ClassifLSTM(hidden_size=8, num_layers=2, num_classes=10, bidirectional=True,
                    remat=True, dropout=0.0)
    return jax.tree.map(np.asarray, m.init({"params": jax.random.PRNGKey(0)}, X[:2],
                                           False)["params"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both spawns' results, the port's single-device references and the
    JAX references."""
    import jax

    from multimodal_hand_pose_enhancement_for_sign_language_tpu import infer as j_infer
    from multimodal_hand_pose_enhancement_for_sign_language_tpu.lifting import (
        engine as j_engine,
        filtering as j_filtering,
    )
    from multimodal_hand_pose_enhancement_for_sign_language_tpu.models import (
        registry as j_registry,
    )
    from multimodal_hand_pose_enhancement_for_sign_language_tpu.parallel import (
        get_mesh as j_get_mesh,
        sequence as j_sequence,
    )

    tmp = tmp_path_factory.mktemp("mesh")
    jt, state0 = _jax_state()
    state = _port_state(state0)
    cls_params = _cls_params()
    infer_X = np.random.RandomState(6).randn(9, T, DIN).astype(np.float32)
    inputs = {"state": state, "cls_params": cls_params, "infer_X": infer_X}
    join2 = _start(_job2, 2, inputs, tmp / "two")
    join4 = _start(_job4, 4, inputs, tmp / "four")

    ref = {"port": _single_steps(state)}
    ref["jax"] = _jax_steps(jt, state0)
    ref["jax_dp"] = _jax_steps(jt, state0, j_get_mesh(2))
    ref["jax_tp_loss"] = _jax_steps(jt, state0, j_get_mesh(4, model_axis=2), tp=True)["g_loss"]
    ref["jax_cls"] = _jax_classifier(cls_params, j_get_mesh(2))
    gvars = {"params": state0["g_params"], "batch_stats": state0["g_stats"]}
    ref["jax_infer"] = np.asarray(j_infer.run_inference(
        j_registry.build_generator("v1", DIN, DOUT, default_size=SIZE), gvars, infer_X,
        batch_size=4, num_samples=100, matmul_precision="float32")[0])
    ref["jax_lift"] = j_engine.lift_clips(_clips(), n_cycles=15, filter_impl="xla")
    f64 = _filter_inputs(64, 1)
    ref["jax_filter"] = [np.asarray(a) for a in j_filtering.filter_xyz(
        *f64, learning_rate=20.0, n_cycles=50)]
    ref["jax_filter_sharded"] = [np.asarray(a) for a in j_sequence.filter_xyz_time_sharded(
        *f64, j_get_mesh(4), learning_rate=20.0, n_cycles=50)]
    del jax

    two, four = join2(), join4()
    return {"two": two, "four": four, "ref": ref, "state": state, "tmp": tmp,
            "infer_X": infer_X}


def _hold(got_sd, grads, want_sd):
    """A post-step state dict against a reference: running statistics and
    parameters outside the sign-noise mask within STEP_ATOL, masked entries
    within 2 lr + STEP_ATOL; returns the masked share."""
    masked = total = 0
    for k, v in got_sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        diff = (v - want_sd[k]).abs()
        if k in grads:
            g = grads[k].abs()
            keep = (g == 0) | (g >= NOISE)
            masked += int((~keep).sum())
            total += keep.numel()
            assert float((diff * ~keep).max()) <= 2 * LR + STEP_ATOL, k
            diff = diff * keep
        assert float(diff.max()) <= STEP_ATOL, (k, float(diff.max()))
    return masked / max(total, 1)


def _hold_steps(got, want, tp_loss_only=False):
    for k in ("g_loss", "d_loss", "val_loss"):
        assert abs(got[k] - want[k]) <= STEP_RTOL * max(1.0, abs(want[k])), (k, got[k], want[k])
    assert _hold(got["g_sd"], got["g_grads"], want["g_sd"]) <= MASKED_SHARE
    assert _hold(got["d_sd"], got["d_grads"], want["d_sd"]) <= MASKED_SHARE


@pytest.mark.parametrize("against", ["port", "jax", "jax_dp"])
def test_dp_steps_match(ranks, against):
    """The 2-rank G, D and val steps against one device (the port's, JAX's)
    and JAX's 2-device DP step."""
    _hold_steps(ranks["two"][0]["steps"], ranks["ref"][against])


def test_dp_ranks_hold_the_same_state(ranks):
    """After the steps every rank holds the same weights and statistics."""
    a, b = (r["steps"] for r in ranks["two"])
    for key in ("g_sd", "d_sd"):
        for k, v in a[key].items():
            assert torch.equal(v, b[key][k]), (key, k)
    assert a["g_loss"] == b["g_loss"] and a["val_loss"] == b["val_loss"]


def test_tp_steps_match_single_device_and_jax(ranks):
    """data 2 x model 2: the G, D and val steps against the port's single
    device at the step tolerances, the G loss against JAX's TP step."""
    got = ranks["four"][0]["steps"]
    _hold_steps(got, ranks["ref"]["port"])
    assert abs(got["g_loss"] - ranks["ref"]["jax_tp_loss"]) < TP_JAX_ATOL


def test_tp_weights_stay_split_and_the_gathered_state_loads(ranks):
    """Every convolution keeps out/2 channels on its rank after the step;
    the gathered state dict loads strictly into a plain generator."""
    got = ranks["four"][0]["steps"]
    whole = ranks["state"]["g"]
    n_split = 0
    for name, shape in got["g_local_shapes"].items():
        if name.endswith("weight") and len(shape) == 3:
            dim = 1 if name.startswith("decoder.5") else 0
            assert shape[dim] * 2 == whole[name].shape[dim], name
            n_split += 1
    assert n_split == 9  # every convolution of v1
    net = t_registry.build_generator("v1", DIN, DOUT, default_size=SIZE, device="cpu")
    net.load_state_dict(got["g_sd"], strict=True)
    for r in ranks["four"][1:]:  # the model ranks gathered the same whole weights
        for k, v in r["steps"]["g_sd"].items():
            assert torch.equal(v, got["g_sd"][k]), k


def test_global_batch_array_takes_each_ranks_rows(ranks):
    """Each rank's own rows (``local_batch_slice``) through
    ``global_batch_array`` take the same step as the global batch."""
    for r, res in enumerate(ranks["two"]):
        assert res["slice"] == (4 * r, 4 * r + 4)
        assert res["gba_loss"] == res["steps"]["g_loss"]
        for k, v in res["gba_g_sd"].items():
            assert torch.equal(v, res["steps"]["g_sd"][k]), k


def test_tp_peers_feed_their_data_indexs_rows(ranks):
    """data 2 x model 2: each rank's ``local_batch_slice(B, mesh)`` rows
    through ``global_batch_array`` take the TP G step of the global batch
    (the step tolerances, the mask at most 1e-3), because the two TP peers
    of a data index feed the same rows: block ``data_index`` of 2."""
    for res in ranks["four"]:
        want = res["steps"]
        assert abs(res["gba_loss"] - want["g_loss"]) <= STEP_RTOL * max(1.0, abs(want["g_loss"]))
        assert _hold(res["gba_g_sd"], res["gba_g_grads"], want["g_sd"]) <= MASKED_SHARE
    assert [r["slice"] for r in ranks["four"]] == [(0, 4), (0, 4), (4, 8), (4, 8)]


def test_dp_dropout_masks_are_the_global_batchs(ranks):
    """Dropout 0.5: the 2-rank G and D steps equal one device's."""
    x, y = (torch.from_numpy(a) for a in _batch())
    tr = _trainer(None, dropout=0.5)
    g, d = float(tr.g_step(x, y)), float(tr.d_step(x, y))
    got = ranks["two"][0]
    assert abs(got["drop_g"] - g) <= DROPOUT_ATOL
    assert abs(got["drop_d"] - d) <= DROPOUT_ATOL
    for k, v in tr.generator.state_dict().items():
        if "running" in k:  # the masks decide these: a wrong mask moves them
            assert float((v - got["drop_g_sd"][k]).abs().max()) <= STEP_ATOL, k


def test_dp_options_match_single_device(ranks):
    """fused_d's 2-rank D step against one device's at the step tolerances;
    a bfloat16 G step against one device's at a bfloat16 rounding (2^-8)."""
    x, y = (torch.from_numpy(a) for a in _batch())
    tr = _trainer(ranks["state"], fused_d=True)
    loss = float(tr.d_step(x, y))
    got_loss, got_sd, got_grads = ranks["two"][0]["fused_d"]
    assert abs(got_loss - loss) <= STEP_RTOL * max(1.0, abs(loss))
    assert _hold(got_sd, got_grads, tr.discriminator.state_dict()) <= MASKED_SHARE
    bf16 = float(_trainer(ranks["state"], compute_dtype="bfloat16").g_step(x, y))
    assert abs(ranks["two"][0]["bf16_g"] - bf16) <= 2.0**-8 * abs(bf16)


@pytest.mark.parametrize("kind", ["host", "resident"])
def test_dp_epoch_matches_single_device(ranks, kind):
    X, Y = _batch(16, seed=4)
    want = _trainer(None, dropout=0.5).run_epoch(X, Y, "g", B)
    got = ranks["two"][0]["epoch" if kind == "host" else "epoch_resident"]
    assert abs(got - want) < EPOCH_ATOL


def test_replicated_batch_keeps_local_statistics(ranks):
    """5 rows over 2 ranks: replicated; the running variance is the
    single-device step's, not one counted over 10 rows."""
    x, y = (torch.from_numpy(a) for a in _batch())
    tr = _trainer(ranks["state"])
    tr.g_step(x[:5], y[:5])
    for k, v in tr.generator.state_dict().items():
        if "running" in k:
            assert torch.equal(v, ranks["two"][0]["odd_g_sd"][k]), k


def test_classifier_dp_step_matches_jax(ranks):
    loss, acc, sd = ranks["two"][0]["cls"]
    j_loss, j_acc, j_sd = ranks["ref"]["jax_cls"]
    assert abs(loss - j_loss) < CLS_ATOL
    assert acc == j_acc
    for k, v in j_sd.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=CLS_ATOL, err_msg=k)
    other = ranks["two"][1]["cls"]
    assert other[:2] == (loss, acc)


def test_sharded_inference_matches(ranks):
    got = ranks["two"][0]["infer"]
    want = t_infer.run_inference(_generator(ranks["state"]), ranks["infer_X"], batch_size=4,
                                 num_samples=100, device="cpu")[0]
    assert got.shape == want.shape == (9, T, DOUT)
    np.testing.assert_allclose(got, want, atol=INFER_SELF_ATOL, rtol=0)
    np.testing.assert_allclose(got, ranks["ref"]["jax_infer"], atol=INFER_JAX_ATOL, rtol=0)
    np.testing.assert_array_equal(ranks["two"][1]["infer"], got)


def test_sharded_lifting_matches(ranks):
    want = t_engine.lift_clips(_clips(), n_cycles=15, device="cpu")
    for res in ranks["two"]:
        for key in ("lift", "lift_file"):
            for a, b in zip(res[key], want):
                np.testing.assert_allclose(a, b, atol=LIFT_SELF_ATOL, rtol=0)
    for a, b in zip(ranks["two"][0]["lift"], ranks["ref"]["jax_lift"]):
        np.testing.assert_allclose(a[:, 0::3], b[:, 0::3], atol=LIFT_ATOL, rtol=0)
        np.testing.assert_allclose(a[:, 1::3], b[:, 1::3], atol=LIFT_ATOL, rtol=0)
        np.testing.assert_allclose(a[:, 2::3], b[:, 2::3], atol=LIFT_Z_ATOL, rtol=0)
    saved = load_binary(str(ranks["tmp"] / "two" / "xyz_lift.pkl"))
    for a, b in zip(saved, ranks["two"][0]["lift_file"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", ["two", "four"])
def test_time_sharded_filter_matches_jax(ranks, world):
    for res in ranks[world]:
        for a, b, c in zip(res["filter64"], ranks["ref"]["jax_filter"],
                           ranks["ref"]["jax_filter_sharded"]):
            np.testing.assert_allclose(a, b, atol=FILTER_ATOL, rtol=0)
            np.testing.assert_allclose(a, c, atol=FILTER_ATOL, rtol=0)


def test_time_sharded_long_clip_matches_plain(ranks):
    ins = [torch.from_numpy(a)[None] for a in _filter_inputs(1920, 2)]
    want = t_filtering.filter_xyz(*ins, learning_rate=20.0, n_cycles=10)
    got = ranks["four"][0]["filter1920"]
    for a, b in zip(got, want):
        assert a.shape == (1920, 50)
        np.testing.assert_allclose(a, b[0].numpy(), atol=FILTER_ATOL, rtol=0)


def test_multihost_without_torchrun(monkeypatch):
    """No torchrun environment: one process, no group, the whole batch."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize("cpu") is False
    assert not dist.is_initialized()
    assert multihost.start("cpu") == (None, "cpu")
    s = multihost.local_batch_slice(32)
    assert (s.start, s.stop) == (0, 32)
    assert multihost.is_main()
    with pytest.raises(RuntimeError, match="initialized"):
        mesh_lib.get_mesh()


@pytest.mark.parametrize("data,model", [(2, 2), (4, 1), (1, 4)])
def test_local_batch_slice_is_the_data_indexs_block(data, model):
    """With a mesh, rank r feeds block r // model of ``data`` blocks; a batch
    that does not divide into them is refused."""
    got = []
    for rank in range(data * model):
        mesh = SimpleNamespace(shape={"data": data, "model": model},
                               data_index=rank // model)
        s = multihost.local_batch_slice(8, mesh)
        got.append((s.start, s.stop))
    per = 8 // data
    assert got == [((r // model) * per, (r // model + 1) * per) for r in range(data * model)]
    if data > 1:
        with pytest.raises(ValueError, match="divide"):
            multihost.local_batch_slice(8 * data + 1, mesh)


def test_mesh_refuses_a_device_its_backend_does_not_serve(tmp_path):
    """A gloo group serves CPU tensors: its mesh is on the CPU, and a caller
    on another device is refused, not switched."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="ranks"):
            mesh_lib.get_mesh(n_devices=2)
        mesh = mesh_lib.get_mesh()
        assert mesh.shape == {"data": 1, "model": 1} and mesh.device.type == "cpu"
        with pytest.raises(ValueError, match="does not match"):
            mesh.check_device("cuda")
        mesh.device = torch.device("cuda")
        with pytest.raises(ValueError, match="does not match"):
            t_gan.GanTrainer(_cfg(), device="cpu", mesh=mesh)
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# train_gan under torchrun
# ----------------------------------------------------------------------
def _cli(data_dir, model_path, launcher):
    cmd = launcher + ["-m", f"{PORT}.train_gan", "--data_dir", data_dir,
                      "--model_path", model_path, "--num_epochs", "1", "--batch_size", "8",
                      "--default_size", str(SIZE), "--loss", "RobustLoss",
                      "--disc_label_smooth", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=os.path.dirname(model_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


def test_train_gan_under_torchrun_matches_one_process(tmp_path):
    data_dir = str(tmp_path / "video_data")
    synthetic.make_r6d_dataset(data_dir, n_clips=12, t_range=(60, 230), seed=11,
                               save_image_feats=False, device="cpu")
    one = str(tmp_path / "one")
    two = str(tmp_path / "two")
    _cli(data_dir, one, [sys.executable])
    proc = _cli(data_dir, two, [sys.executable, "-m", "torch.distributed.run",
                                "--standalone", "--nproc_per_node=2"])
    assert "data-parallel over Mesh(data=2, model=1, rank=0" in proc.stdout
    assert "rank=1" not in proc.stdout  # rank 1 prints nothing

    def metrics(d):
        with open(os.path.join(d, "metrics_experiment.jsonl")) as f:
            return [json.loads(line) for line in f if "loss_" in line]

    a, b = metrics(one), metrics(two)
    assert len(a) == len(b) == 2  # epoch 0: G, then val
    for ra, rb in zip(a, b):
        for k in ("loss_train_gen", "loss_val_gen"):
            if k in ra:
                assert abs(ra[k] - rb[k]) <= STEP_RTOL * max(1.0, abs(ra[k])), k
    ca = t_ckpt.load_checkpoint(os.path.join(one, "experiment_checkpoint.pth"))
    cb = t_ckpt.load_checkpoint(os.path.join(two, "experiment_checkpoint.pth"))
    n_steps = 2  # 16 training windows at batch 8
    for key in ("state_dict", "discriminator"):
        off = total = 0
        for k, v in ca[key].items():
            if k.endswith("num_batches_tracked"):
                assert torch.equal(v, cb[key][k])
                continue
            diff = (v - cb[key][k]).abs()
            assert float(diff.max()) <= 2 * LR * n_steps + STEP_ATOL, k
            off += int((diff > STEP_ATOL).sum())
            total += diff.numel()
        assert off / total <= MASKED_SHARE, key
    assert sorted(os.listdir(two)) == sorted(os.listdir(one))
