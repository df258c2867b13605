"""Article replay of the port: the root ``article_replay.py``, every stage
through the port's own CLIs.

    python -m multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.article_replay \\
        [--scale {article,small,tiny}] [--device cpu] [--fingers 1..5] ...

Chains, end to end, the workload the article and its launcher define
(launch_exp_incr_fingers.sh:10-20, article §4.1.3 and §5.2; BASELINE.md):

  1. fixture        -- the port's ``data/synthetic.make_r6d_dataset`` at the
                       chosen scale, made on ``--device`` (article scale:
                       31,128 / 1,741 / 2,322 sentence-level windows), or
                       ``--data_dir`` with real How2Sign pickles, read as
                       they are.
  2. raw smoke      -- a small OpenPose-format tree through the port's
                       ``process_dataset --lift`` (JSON ingestion, 60-cycle
                       lifting through ``filter_sgd``, r6d).
  3. train          -- the two canonical configs through the port's
                       ``train_gan``: v1/arm2wh/L1 (Table 1) and
                       v2+text/arm_wh2finger1/RobustLoss (Table 2's corner;
                       every G and val step through ``robust_loss``).
  4. inference      -- L1 per split through the port's ``inference`` and its
                       r6d/aa/xyz result pickles per config.
  5. classifier     -- the LSTM topic classifier on the ground-truth r6d and
                       on the enhanced r6d of the same windows (the article's
                       surrogate evaluation, §5.2), the reference-config and
                       ablation classifiers on request, and the text MLP.
  6. finger trend   -- with ``--fingers``, one v2+text RobustLoss run per
                       masked-finger count K (Table 2's series).

Writes a report with the root's keys (per-stage wall times, the
Table-shaped L1 numbers, the classifier accuracies, the article's
published numbers beside them) to ``--out``, by default
``ARTICLE_REPLAY_torch.json``, so that it never overwrites a report of the
JAX package.  Each flush writes a temporary file and renames it over the
report; on ``--resume`` the prior report's entries are in the report from
its first flush on.  On the synthetic fixture the absolute numbers are not
the article's; ``--data_dir`` with the real pickles gives the real table.

Runs on one CUDA device unless ``--device cpu``; asking for CUDA where
there is none raises before any work.  Not ported: the root's GIF output of
two test sequences (``seqs_to_viz``: the port's inference CLI renders
none), its pickle cache across configs (``MHPE_LOAD_DATA_CACHE``), and its
recovery helpers for a mirrored work directory and for reports older than
the fixture fingerprint.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import time

import numpy as np

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch import (
    classifier_main,
    classifier_mlp_main,
    inference,
    process_dataset,
    train_gan,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import (
    synthetic,
    windows as win_lib,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.io import (
    load_binary,
    save_binary,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.device import (
    resolve_device,
)

# article-published numbers (BASELINE.md; article Tables 1/2, §4.1.3, §5.2)
ARTICLE_REFERENCE = {
    "table1_arm2wh_L1": {"train": 2.36, "val": 2.38, "test": 2.39},
    "table1_arm2wh_text_L1": {"train": 2.37, "val": 2.38, "test": 2.38},
    "table2_finger1_L1": {"val": 0.320, "test": 0.324},
    # full Table 2 masked-finger series, K = 1..5 (BASELINE.md:14-15)
    "table2_finger_trend_L1": {
        "val": [0.320, 0.331, 0.338, 0.382, 0.418],
        "test": [0.324, 0.330, 0.341, 0.381, 0.411],
    },
    # Table 2's third row, "val L1 per masked finger" (BASELINE.md:16):
    # exactly the first row divided by K (0.331/2=0.166, 0.338/3=0.113,
    # 0.382/4=0.096, 0.418/5=0.084) — the article's per-finger figure is
    # the total L1 amortized over the K masked fingers
    "table2_finger_per_finger_L1_val": [0.320, 0.166, 0.113, 0.096, 0.084],
    "classifier_val_acc_text_mlp": 0.77,
    "train_wallclock": "2 h / 200 epochs, batch 256, 1 GPU (article 4.1.3)",
    "dataset_scale": {"train": 31128, "val": 1741, "test": 2322},
}

SCALES = {
    "article": {"train": 31128, "val": 1741, "test": 2322},
    "small": {"train": 256, "val": 64, "test": 64},
    "tiny": {"train": 24, "val": 8, "test": 8},
}

# the two canonical configs: Table 1's plain body->hands row and the
# finger-masking experiment's v2+text corner
CONFIGS = [
    dict(
        name="arm2wh_v1_L1",
        model="v1", pipeline="arm2wh", loss="L1",
        require_text=False, learning_rate=1e-4,
    ),
    dict(
        name="arm_wh2finger1_v2_text_RobustLoss",
        model="v2", pipeline="arm_wh2finger1", loss="RobustLoss",
        require_text=True, learning_rate=1e-3,  # launcher lr, :14
    ),
]

# the reference classifier's own hyperparameters
# (H2Sclassifier/Train_Test/main.py:143-160), for --reference_classifier
REFERENCE_CLASSIFIER = dict(classifier_hidden=1024, classifier_layers=10,
                            classifier_bidir=True)

# the report's entries that hold stage results measured on the fixture
STAGE_KEYS = ("configs", "classifier", "core_completed", "finger_trend",
              "finger_trend_epochs", "finger_trend_vs_article")


def stage_fixture(args, work):
    """Synthetic pickles at ``--scale`` made on ``--device``, or the user's
    ``--data_dir`` as it is."""
    if args.data_dir:
        return args.data_dir, {"source": args.data_dir, "wall_s": 0.0}

    data_dir = os.path.join(work, "video_data")
    counts = SCALES[args.scale]
    small = args.scale in ("small", "tiny")
    t0 = time.perf_counter()
    synthetic.make_r6d_dataset(
        data_dir, split_counts=counts, seed=7, save_image_feats=small,
        ik_roundtrip=small, categ_signal=args.signal_fixture,
        finger_signal=args.finger_signal, device=args.device,
    )
    wall = time.perf_counter() - t0
    fingerprint = _fixture_fingerprint(data_dir)
    with open(os.path.join(data_dir, "fixture_meta.json"), "w") as f:
        json.dump({"categ_signal": args.signal_fixture,
                   "finger_signal": args.finger_signal,
                   "counts": counts, "seed": 7,
                   "fingerprint": fingerprint}, f)
    print(f"[fixture] {counts} in {wall:.1f}s -> {data_dir}", flush=True)
    return data_dir, {"source": "synthetic", "counts": counts, "wall_s": wall,
                      "categ_signal": args.signal_fixture,
                      "finger_signal": args.finger_signal,
                      "fingerprint": fingerprint}


def _fixture_fingerprint(data_dir):
    """Content fingerprint of a fixture dir: sha256 over the sorted
    (name, file-sha256) pairs of every pickle in it.

    The synthetic fixture is deterministic (fixed seed), so a fixture
    regenerated for a ``--resume`` whose fingerprint equals the one in the
    prior report is the data the surviving checkpoints were trained on,
    and their stage results stay valid."""
    outer = hashlib.sha256()
    for name in sorted(os.listdir(data_dir)):
        if not name.endswith(".pkl"):
            continue
        h = hashlib.sha256()
        with open(os.path.join(data_dir, name), "rb") as f:
            for chunk in iter(lambda: f.read(8 << 20), b""):
                h.update(chunk)
        outer.update(name.encode())
        outer.update(h.digest())
    return outer.hexdigest()


def _finger_trend_comparison(trend):
    """How the replay's masked-finger L1 series matches article Table 2's
    shape (BASELINE.md:14-15), per split: the Pearson and rank (Spearman)
    correlations against the article's series over the K the article has
    (K ≤ 5), and strict monotonicity of the whole series.  Both need at
    least three points."""
    ks = sorted(int(k) for k in trend if "inference" in trend[k])
    out = {"K": ks}
    art = ARTICLE_REFERENCE["table2_finger_trend_L1"]
    for split in ("val", "test"):
        series = [trend[str(k)]["inference"]["L1"][split] for k in ks]
        ref = [art[split][k - 1] for k in ks if k - 1 < len(art[split])]
        entry = {"replay_L1": series, "article_L1": ref}
        if len(ref) >= 3:
            # ks is sorted, so the K the article has are the series' prefix
            a = np.asarray(series[: len(ref)], dtype=np.float64)
            b = np.asarray(ref, dtype=np.float64)
            entry["pearson_r"] = _corr(a, b)
            entry["spearman_r"] = _corr(_ranks(a), _ranks(b))
        if len(series) >= 3:
            entry["strictly_monotone"] = bool(np.all(np.diff(series) > 0))
        if split == "val":
            # Table 2 row 3 ("val L1 per masked finger") is row 1
            # amortized over the K masked fingers — derive the replay's
            # counterpart the same way
            per_finger = ARTICLE_REFERENCE["table2_finger_per_finger_L1_val"]
            entry["replay_L1_per_finger"] = [v / k for v, k in zip(series, ks)]
            entry["article_L1_per_finger"] = [
                per_finger[k - 1] for k in ks if k - 1 < len(per_finger)
            ]
        out[split] = entry
    return out


def _corr(x, y):
    # a flat series has zero variance -> corrcoef is NaN, which is not
    # valid strict JSON; report null instead
    if np.std(x) == 0.0 or np.std(y) == 0.0:
        return None
    return float(np.corrcoef(x, y)[0, 1])


def _ranks(x):
    # average ranks for ties — argsort-of-argsort would rank a flat series
    # 0..n-1 by index and fake a perfect match
    order = np.argsort(x, kind="stable")
    pos = np.empty(len(x), dtype=np.float64)
    pos[order] = np.arange(len(x), dtype=np.float64)
    _, inv = np.unique(x, return_inverse=True)
    out = np.empty(len(x), dtype=np.float64)
    for g in range(inv.max() + 1):
        m = inv == g
        out[m] = pos[m].mean()
    return out


def _parse_fingers(spec):
    """Masked-finger counts from '--fingers': comma list '1,2,5' or range
    '1..5' -> [1, 2, 3, 4, 5] (the launcher's sweep shape,
    launch_exp_incr_fingers.sh:10)."""
    if ".." in spec:
        lo, hi = spec.split("..")
        return list(range(int(lo), int(hi) + 1))
    return [int(k) for k in spec.split(",") if k]


def _last_run_records(metrics_path):
    """Records of the LAST training run in a metrics JSONL.

    MetricsSink appends, so a re-trained stage stacks runs in one file; an
    epoch number lower than its predecessor marks a restart.  Only the
    final run's records may be trusted for resume decisions."""
    runs, cur, prev_epoch = [], [], None
    with open(metrics_path) as f:
        for line in f:
            rec = json.loads(line)
            e = rec.get("epoch")
            if e is not None and prev_epoch is not None and e < prev_epoch:
                runs.append(cur)
                cur = []
            if e is not None:
                prev_epoch = e
            cur.append(rec)
    runs.append(cur)
    return runs[-1]


def _metrics_best_val(metrics_path):
    """Best (min) validation generator loss of the LAST training run in a
    metrics JSONL: a completed train stage's result on resume."""
    best = None
    for rec in _last_run_records(metrics_path):
        if "loss_val_gen" in rec:
            v = float(rec["loss_val_gen"])
            best = v if best is None else min(best, v)
    return best


def _metrics_best_val_epoch(metrics_path):
    """Epoch at which the LAST run's best (min) val loss occurred.  The
    train CLI logs the val loss as its own record right after the epoch's
    train record, so it belongs to the most recent epoch seen."""
    best, best_epoch, cur_epoch = None, None, None
    for rec in _last_run_records(metrics_path):
        if "epoch" in rec:
            cur_epoch = int(rec["epoch"])
        if "loss_val_gen" in rec:
            v = float(rec["loss_val_gen"])
            if best is None or v < best:
                best, best_epoch = v, cur_epoch
    return best_epoch


def _metrics_epochs_done(metrics_path):
    """Number of training epochs the LAST run of a metrics JSONL recorded.
    A checkpoint is written during training, so a train stage only counts
    as done when its last run reached the requested epoch count."""
    last = -1
    for rec in _last_run_records(metrics_path):
        if "epoch" in rec:
            last = max(last, int(rec["epoch"]))
    return last + 1


def stage_raw_smoke(work, args):
    """OpenPose JSON tree -> the port's process_dataset --lift -> r6d
    pickles: the raw-data entry of the pipeline, end to end at small
    scale."""
    raw_root = os.path.join(work, "raw_tree")
    out_dir = os.path.join(work, "raw_processed")
    t0 = time.perf_counter()
    fix = synthetic.make_openpose_tree(
        raw_root, n_videos=2, utts_per_video=2, frames=24, seed=3
    )
    ns = process_dataset.build_parser().parse_args(
        [
            "--dataset_path", fix["dataset_path"],
            "--data_dir", out_dir,
            "--text_path_template",
            os.path.join(fix["dataset_path"], "{split}.text.id.en"),
            "--categ_path_template",
            os.path.join(fix["dataset_path"], "videoID_categoryID_{split}.csv"),
            "--lift",
            "--no-group_by_clip",
            "--n_partitions", "2",
            "--n_cycles", "60",
            "--device", args.device,
        ]
    )
    process_dataset.main(ns)
    wall = time.perf_counter() - t0
    produced = sorted(os.listdir(out_dir))
    if not any(f.startswith("r6d_train") for f in produced):
        raise RuntimeError(f"raw smoke wrote no r6d_train pickle: {produced}")
    print(f"[raw smoke] {len(produced)} artifacts in {wall:.1f}s", flush=True)
    return {"wall_s": wall, "artifacts": produced}


def stage_train(cfg, data_dir, model_dir, args):
    ns = train_gan.build_parser().parse_args([])
    ns.model = cfg["model"]
    ns.pipeline = cfg["pipeline"]
    ns.loss = cfg["loss"]
    ns.require_text = cfg["require_text"]
    ns.learning_rate = cfg["learning_rate"]
    ns.num_epochs = args.epochs
    ns.batch_size = args.batch_size
    ns.epochs_train_disc = 3  # adversarial every 3rd epoch (article 4.1.3)
    ns.patience = max(args.epochs, 1000)  # launcher --patience 1000
    ns.data_dir = data_dir
    ns.model_path = model_dir
    ns.exp_name = cfg["name"]
    ns.epoch_scan = not args.no_epoch_scan  # the device-resident epochs
    ns.device = args.device
    t0 = time.perf_counter()
    best_val = train_gan.main(ns)
    wall = time.perf_counter() - t0
    metrics = os.path.join(model_dir, f"metrics_{cfg['name']}.jsonl")
    best_epoch = (
        _metrics_best_val_epoch(metrics) if os.path.exists(metrics) else None
    )
    print(f"[train {cfg['name']}] best val {best_val:.4f} "
          f"(epoch {best_epoch}) in {wall:.1f}s", flush=True)
    return {"best_val": float(best_val), "best_val_epoch": best_epoch,
            "wall_s": wall,
            "epochs": args.epochs, "batch_size": args.batch_size,
            "learning_rate": cfg["learning_rate"]}


def stage_infer(cfg, data_dir, model_dir, args, prior=None, on_split=None,
                splits=("train", "val", "test")):
    res = {"L1": {}, "wall_s": {}}
    if prior:  # --resume: keep already-measured splits
        res["L1"].update(prior.get("L1", {}))
        res["wall_s"].update(prior.get("wall_s", {}))

    # A split only counts as resumable if its result pickles are still on
    # disk: the classifier stages read them
    res_dir = os.path.join(
        os.path.dirname(model_dir), f"results_{cfg['name']}"
    )

    def _artifacts_ok(split):
        return all(
            os.path.exists(os.path.join(res_dir, f"{k}_{split}.pkl"))
            for k in ("r6d", "aa", "xyz")
        )

    for split in splits:
        if split in res["L1"]:
            if _artifacts_ok(split):
                print(f"[infer {cfg['name']}/{split}] resumed: "
                      f"L1 {res['L1'][split]:.4f}", flush=True)
                continue
            print(f"[infer {cfg['name']}/{split}] report has L1 "
                  f"{res['L1'][split]:.4f} but result pickles are "
                  f"missing from {res_dir} — re-running", flush=True)
            res["L1"].pop(split, None)
            res["wall_s"].pop(split, None)
        ns = inference.build_parser().parse_args([])
        ns.checkpoint = os.path.join(
            model_dir, f"lastCheckpoint_{cfg['name']}.pth"
        )
        ns.data_dir = data_dir
        ns.base_path = os.path.dirname(model_dir)
        ns.pipeline = cfg["pipeline"]
        ns.model = cfg["model"]
        ns.require_text = cfg["require_text"]
        ns.infer_set = split
        ns.exp_name = cfg["name"]
        ns.batch_size = args.batch_size
        # the reference caps inference at --num_samples (default 3000; its
        # launcher passes 1000); -1 takes every window
        ns.num_samples = args.num_samples if args.num_samples > 0 else 10**9
        ns.device = args.device
        t0 = time.perf_counter()
        err = inference.main(ns)
        res["L1"][split] = float(err)
        res["wall_s"][split] = time.perf_counter() - t0
        print(f"[infer {cfg['name']}/{split}] L1 {err:.4f} "
              f"({res['wall_s'][split]:.1f}s)", flush=True)
        if on_split is not None:
            on_split(res)
    return res


def _selection_indices(res_dir, data_dir, split, require_text=False):
    """Original clip indices of the result rows in ``res_dir``.

    Inference writes them as sel_indices_{split}.pkl (the num_samples cap
    and NaN drops make result row j come from clip sel[j], so category
    labels must be subset with sel to stay aligned).  Without that file the
    selection is rebuilt: it is the first-N-NaN-surviving-window rule of
    ``load_windows`` / ``run_inference``.  ``require_text`` must match the
    config that wrote the results: a text-conditioned inference also drops
    clips whose sentence-embedding row has NaNs."""
    p = os.path.join(res_dir, f"sel_indices_{split}.pkl")
    if os.path.exists(p):
        return load_binary(p)
    results = load_binary(os.path.join(res_dir, f"r6d_{split}.pkl"))
    clips = load_binary(os.path.join(data_dir, f"r6d_{split}.pkl"))
    feats = None
    if require_text:
        feats = load_binary(
            os.path.join(data_dir, f"{split}_sentence_embeddings.pkl")
        )
    sel = win_lib.first_valid_window_indices(clips, len(results), feats=feats)
    if len(sel) != len(results):
        raise ValueError(f"{res_dir}: {len(results)} result rows, but only "
                         f"{len(sel)} valid {split} windows")
    return sel


def _build_gt_subset(data_dir, out_dir, sel):
    """GT r6d pickles restricted to the clips the enhanced results cover,
    so that the GT-vs-enhanced classifier comparison is like for like
    (same windows, same labels)."""
    os.makedirs(out_dir, exist_ok=True)
    for split in ("train", "val"):
        clips = load_binary(os.path.join(data_dir, f"r6d_{split}.pkl"))
        save_binary(
            [clips[i] for i in sel[split]],
            os.path.join(out_dir, f"r6d_{split}.pkl"),
        )


def stage_classifier(tag, r6d_dir, data_dir, model_dir, args, sel=None):
    """LSTM topic classifier on the r6d pickles in `r6d_dir` (a GT subset
    dir or a results_{exp} dir); categs come from the fixture `data_dir`,
    subset by `sel` (split -> original clip indices) when given so labels
    stay aligned with capped/NaN-filtered result windows."""
    for split in ("train", "val"):
        src = os.path.join(data_dir, f"categs_{split}.pkl")
        dst = os.path.join(r6d_dir, f"categs_{split}.pkl")
        if sel is not None:
            categs = list(load_binary(src))
            save_binary([categs[i] for i in sel[split]], dst)
        elif os.path.abspath(src) != os.path.abspath(dst):
            shutil.copyfile(src, dst)
    ns = classifier_main.build_parser().parse_args([])
    ns.data_dir = r6d_dir
    ns.models_dir = os.path.join(model_dir, f"classifier_{tag}")
    ns.num_epochs = args.classifier_epochs
    ns.batch_size = args.classifier_batch
    ns.hidden_size = args.classifier_hidden
    ns.num_layers = args.classifier_layers
    ns.bidir = args.classifier_bidir
    ns.no_remat = False
    ns.epoch_scan = True  # device-resident: no per-step batch uploads
    ns.device = args.device
    t0 = time.perf_counter()
    acc = classifier_main.main(ns)
    wall = time.perf_counter() - t0
    print(f"[classifier {tag}] best val acc {acc:.4f} in {wall:.1f}s",
          flush=True)
    return {"best_val_acc": float(acc), "wall_s": wall,
            "epochs": ns.num_epochs, "hidden": ns.hidden_size,
            "layers": ns.num_layers}


def _build_masked_r6d(src_dir, out_dir, zero_cols):
    """Derived classifier dataset: the r6d pickles of ``src_dir`` with the
    columns in ``zero_cols`` (a slice into the 288-dim full-body r6d
    layout) zeroed.  Zero is a constant post-standardization, so the
    zeroed stream carries no label information."""
    os.makedirs(out_dir, exist_ok=True)
    for split in ("train", "val"):
        clips = load_binary(os.path.join(src_dir, f"r6d_{split}.pkl"))
        masked = []
        for c in clips:
            c = np.array(c, copy=True)
            c[:, zero_cols] = 0.0
            masked.append(c)
        save_binary(masked, os.path.join(out_dir, f"r6d_{split}.pkl"))


def stage_anomaly_controls(cls, work, data_dir, model_dir, args, sel):
    """Mechanism controls for an enhanced-hands classifier that out-scores
    the GT hands on a signal fixture.

    CONFIGS[0] (arm2wh/v1), whose results the classifier consumes, is
    text-free, so the enhanced hands are a function of the arms alone.
    Three ablation classifiers at the main stages' budget, and one at 3x,
    separate the streams: ``gt_arms_only`` (hands zeroed: the label
    information the arms carry), ``gt_hands_only`` (arms zeroed: that of
    the noisy GT hands), ``enhanced_hands_only`` (arms zeroed in the
    enhanced results: that of the generated hands) and
    ``gt_arms_only_long`` (the first at 3x the epochs: how much of a gap is
    the classifier's budget rather than information)."""
    arm_cols, hand_cols = win_lib.pipeline_column_slices("arm2wh")
    res_dir = os.path.join(work, f"results_{CONFIGS[0]['name']}")
    gt_dir = os.path.join(work, "classifier_gt_subset")
    controls = cls.setdefault("anomaly_controls", {})
    long_args = argparse.Namespace(**vars(args))
    long_args.classifier_epochs = 3 * args.classifier_epochs
    specs = [
        ("gt_arms_only", gt_dir, hand_cols, args),
        ("gt_hands_only", gt_dir, arm_cols, args),
        ("enhanced_hands_only", res_dir, arm_cols, args),
        ("gt_arms_only_long", gt_dir, hand_cols, long_args),
    ]
    out = {}
    for tag, src, zero_cols, st_args in specs:
        if tag not in controls:
            ctl_dir = os.path.join(work, f"classifier_ctl_{tag}")
            _build_masked_r6d(src, ctl_dir, zero_cols)
            controls[tag] = stage_classifier(
                f"ctl_{tag}", ctl_dir, data_dir, model_dir, st_args, sel=sel
            )
        out[tag] = controls[tag]["best_val_acc"]
    arms, gh, eh, arms_long = (
        out["gt_arms_only"], out["gt_hands_only"],
        out["enhanced_hands_only"], out["gt_arms_only_long"],
    )
    if eh > gh:
        controls["explanation"] = (
            f"CONFIRMED arm->hand signal transfer: the enhanced hand "
            f"channels are a deterministic function of the GT arms "
            f"(CONFIGS[0] is text-free), so their label signal is "
            f"arm-borne by construction; enhanced hands alone score "
            f"{eh:.3f} vs noisy GT hands alone {gh:.3f}.  enhanced "
            f"hands > arms alone ({eh:.3f} vs {arms:.3f}, "
            f"{arms_long:.3f} at 3x budget) is an EXTRACTABILITY gap — "
            f"the generator re-represents arm-borne class signal as "
            f"smooth hand trajectories a fixed-budget LSTM reads more "
            f"easily — not information creation (the data-processing "
            f"inequality bounds information, not accuracy).  So "
            f"'enhanced beats GT' reflects fixture construction (class "
            f"signature on the input channels), and the article's §5.2 "
            f"preservation logic should be read against gt_arms_only."
        )
    else:
        controls["explanation"] = (
            f"controls did NOT confirm the arm-transfer hypothesis "
            f"(arms_only {arms:.3f}/{arms_long:.3f} long, gt_hands_only "
            f"{gh:.3f}, enhanced_hands_only {eh:.3f}); mechanism "
            f"unresolved."
        )
    print(f"[anomaly controls] {controls['explanation']}", flush=True)


def stage_mlp_classifier(data_dir, model_dir, args):
    """The article's text baseline (§5.2.2: MiniLM sentence embeddings ->
    MLP, 77% val accuracy on real data)."""
    ns = classifier_mlp_main.build_parser().parse_args([])
    ns.data_dir = data_dir
    ns.models_dir = os.path.join(model_dir, "classifier_mlp")
    ns.num_epochs = args.classifier_epochs
    ns.batch_size = args.classifier_batch
    ns.device = args.device
    t0 = time.perf_counter()
    acc = classifier_mlp_main.main(ns)
    wall = time.perf_counter() - t0
    print(f"[classifier mlp-text] best val acc {acc:.4f} in {wall:.1f}s",
          flush=True)
    return {"best_val_acc": float(acc), "wall_s": wall,
            "epochs": ns.num_epochs}


def _flush_report(report, out_path):
    """Persist the report after every stage: a temporary file renamed over
    the report, so that a run cut anywhere leaves the last whole report."""
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1)
    os.replace(tmp, out_path)


def _fixture_notes(args):
    """What each stage can and cannot show on the synthetic fixture, so
    that the report reads without other documents."""
    notes = {"n_classes": 9, "classifier_chance_acc": round(1.0 / 9, 4)}
    if not args.signal_fixture:
        notes["labels"] = (
            "signal-free: categoryID labels are independent of the "
            "pose/text streams by construction, so EVERY classifier "
            "accuracy below is expected to sit at chance (~0.111); "
            "the classifier stages here prove plumbing at article "
            "scale, not learning.  Run with --signal_fixture for a "
            "discriminative surrogate eval."
        )
    else:
        notes["labels"] = (
            "signal-bearing (categ_signal=True): each class plants a "
            "distinct angular oscillation in the pose streams and a "
            "centroid in the sentence embeddings, so classifier "
            "accuracies well above chance (~0.111) demonstrate "
            "actual learning.  NOTE: the class signature rides on "
            "the ARM channels too, so an enhanced-hands classifier "
            "can out-score the noisy GT hands by reading denoised "
            "arm-borne class signal — see anomaly_controls."
        )
    if args.finger_signal:
        notes["fingers"] = (
            "finger_signal=True: hand channels carry a Markov chain "
            "over the channel index rooted in a per-clip latent that "
            "the sentence embeddings also encode; recoverable "
            "information decays geometrically with distance from the "
            "nearest visible channel, so the masked-finger L1 trend "
            "(article Table 2's monotone 0.320->0.418 shape) is "
            "expected to RISE with K on this fixture."
        )
    elif args.fingers:
        notes["fingers"] = (
            "finger_signal=False: hand channels carry no "
            "text-predictable per-finger structure, so the "
            "masked-finger L1 trend is expected to be FLAT (plumbing "
            "only).  Run with --finger_signal for Table 2's shape."
        )
    return notes


def _train_artifacts_ok(model_dir, cfg):
    """Inference needs the checkpoint and the standardization stats."""
    return all(os.path.exists(os.path.join(model_dir, f)) for f in (
        f"lastCheckpoint_{cfg['name']}.pth",
        f"{cfg['name']}{cfg['pipeline']}_preprocess_core.npz"))


def _resumed_train(cfg, model_dir, epochs, resumable):
    """A train entry rebuilt from the metrics of a finished run, or None;
    ``resumable``: --resume on the fixture the run trained on."""
    metrics = os.path.join(model_dir, f"metrics_{cfg['name']}.jsonl")
    if not (resumable and _train_artifacts_ok(model_dir, cfg)
            and os.path.exists(metrics) and _metrics_epochs_done(metrics) >= epochs):
        return None
    print(f"[train {cfg['name']}] resumed from {metrics}", flush=True)
    return {"resumed": True, "best_val": _metrics_best_val(metrics),
            "best_val_epoch": _metrics_best_val_epoch(metrics), "epochs": epochs}


def main(args):
    resolve_device(args.device)  # refuse before any work
    work = os.path.abspath(args.work_dir)
    os.makedirs(work, exist_ok=True)
    model_dir = os.path.join(work, "models")
    os.makedirs(model_dir, exist_ok=True)
    # --resume: reuse stage results from a prior report, plus on-disk
    # artifacts (fixture pickles, training checkpoints) of a run that never
    # wrote its report.  The prior entries are in the report from its first
    # flush on, so a run cut at any point loses none of them.
    prior = {}
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            prior = json.load(f)
    report = {
        **prior,
        "scale": args.scale if not args.data_dir else "user-data",
        "epochs": args.epochs,
        "completed": False,
        "article_reference": ARTICLE_REFERENCE,
    }
    report.pop("total_wall_s", None)
    t_total = time.perf_counter()

    if not args.skip_raw_smoke:
        raw_out = os.path.join(work, "raw_processed")
        if "raw_pipeline_smoke" in prior:
            report["raw_pipeline_smoke"] = prior["raw_pipeline_smoke"]
        elif args.resume and os.path.exists(
            os.path.join(raw_out, "r6d_train.pkl")
        ):
            report["raw_pipeline_smoke"] = {
                "resumed": True, "artifacts": sorted(os.listdir(raw_out))
            }
            print("[raw smoke] resumed from on-disk artifacts", flush=True)
        else:
            report["raw_pipeline_smoke"] = stage_raw_smoke(work, args)
        _flush_report(report, args.out)

    # a fixture may only be reused if it was made with the requested
    # options and scale (fixture_meta.json)
    fixture_meta = os.path.join(work, "video_data", "fixture_meta.json")
    on_disk = {}
    if os.path.exists(fixture_meta):
        with open(fixture_meta) as f:
            on_disk = json.load(f)
    if (
        args.resume
        and not args.data_dir
        and os.path.exists(os.path.join(work, "video_data", "r6d_train.pkl"))
        and bool(on_disk.get("categ_signal", False)) == args.signal_fixture
        and bool(on_disk.get("finger_signal", False)) == args.finger_signal
        and on_disk.get("counts") == SCALES[args.scale]
        and "fingerprint" in on_disk
    ):
        data_dir = os.path.join(work, "video_data")
        fixture_info = {"source": "synthetic", "resumed": True,
                        "counts": SCALES[args.scale],
                        "categ_signal": args.signal_fixture,
                        "finger_signal": args.finger_signal,
                        "fingerprint": on_disk["fingerprint"]}
        print(f"[fixture] resumed from {data_dir}", flush=True)
    else:
        data_dir, fixture_info = stage_fixture(args, work)
    report["fixture"] = fixture_info
    report.pop("fixture_notes", None)
    if not args.data_dir:
        report["fixture_notes"] = _fixture_notes(args)

    # A regenerated synthetic fixture invalidates the stage results of this
    # work dir unless its content fingerprint equals the prior report's
    # (the fixture is deterministic, so then it is the same data).  User
    # --data_dir is external and unchanged, so stage resume stays valid.
    stage_resume_ok = bool(args.data_dir) or fixture_info.get("resumed", False)
    if args.resume and not stage_resume_ok:
        prior_fp = (prior.get("fixture") or {}).get("fingerprint")
        if prior_fp and prior_fp == fixture_info.get("fingerprint"):
            stage_resume_ok = True
            print("[resume] regenerated fixture fingerprint matches the "
                  "prior report — prior stage results stay valid",
                  flush=True)
        else:
            print("[resume] fixture was regenerated — prior stage results/"
                  "checkpoints in this work dir refer to the OLD fixture "
                  "and will NOT be reused", flush=True)
            prior = {}
            for key in STAGE_KEYS:
                report.pop(key, None)
    prior_cfgs = prior.get("configs", {})
    resumable = args.resume and stage_resume_ok
    _flush_report(report, args.out)

    selected = (
        [c for c in CONFIGS if c["name"] in args.configs.split(",")]
        if args.configs else CONFIGS
    )
    if args.configs and len(selected) != len(args.configs.split(",")):
        raise SystemExit(
            f"--configs {args.configs!r}: unknown name "
            f"(have {[c['name'] for c in CONFIGS]})"
        )
    if not args.skip_classifier and CONFIGS[0] not in selected:
        raise SystemExit(
            f"the classifier stage consumes {CONFIGS[0]['name']}'s "
            "results; include it in --configs or pass --skip_classifier"
        )
    configs = report.setdefault("configs", {})
    for cfg in selected:
        entry = {"pipeline": cfg["pipeline"], "model": cfg["model"],
                 "loss": cfg["loss"], "require_text": cfg["require_text"]}
        prior_entry = prior_cfgs.get(cfg["name"], {})
        train_ok = _train_artifacts_ok(model_dir, cfg)
        if "train" in prior_entry and not train_ok:
            print(f"[train {cfg['name']}] prior report entry found but "
                  f"checkpoint/stats files are missing from {model_dir} "
                  f"— re-training", flush=True)
        if "train" in prior_entry and train_ok:
            entry["train"] = prior_entry["train"]
        else:
            resumed = _resumed_train(cfg, model_dir, args.epochs, resumable)
            if resumed is not None:
                entry["train"] = dict(resumed, batch_size=args.batch_size,
                                      learning_rate=cfg["learning_rate"])
            else:
                entry["train"] = stage_train(cfg, data_dir, model_dir, args)
        configs[cfg["name"]] = entry
        _flush_report(report, args.out)

        def _on_split(res, entry=entry):
            entry["inference"] = res
            _flush_report(report, args.out)

        # prior inference L1s are only valid against the checkpoint they
        # were measured with: a re-trained config invalidates them
        entry["inference"] = stage_infer(
            cfg, data_dir, model_dir, args,
            prior=(prior_entry.get("inference")
                   if entry["train"] is prior_entry.get("train")
                   or entry["train"].get("resumed") else None),
            on_split=_on_split,
        )
        _flush_report(report, args.out)

    if not args.skip_classifier:
        # the article's surrogate eval (§5.2): GT sequences vs the enhanced
        # sequences of config A's save_results, on the same windows with
        # aligned labels
        cls = report["classifier"] = dict(prior.get("classifier", {}))
        res_dir = os.path.join(work, f"results_{CONFIGS[0]['name']}")
        _sel_cache = {}

        def get_sel():
            if "sel" not in _sel_cache:
                _sel_cache["sel"] = {
                    s: _selection_indices(
                        res_dir, data_dir, s,
                        require_text=CONFIGS[0]["require_text"],
                    )
                    for s in ("train", "val")
                }
                cls["windows"] = {
                    s: len(_sel_cache["sel"][s]) for s in _sel_cache["sel"]
                }
            return _sel_cache["sel"]

        if "ground_truth_r6d" not in cls:
            sel = get_sel()
            gt_dir = os.path.join(work, "classifier_gt_subset")
            _build_gt_subset(data_dir, gt_dir, sel)
            cls["ground_truth_r6d"] = stage_classifier(
                "gt", gt_dir, data_dir, model_dir, args, sel=sel
            )
            _flush_report(report, args.out)
        if "enhanced_r6d" not in cls:
            cls["enhanced_r6d"] = stage_classifier(
                "enhanced", res_dir, data_dir, model_dir, args, sel=get_sel()
            )
            _flush_report(report, args.out)
        if (
            args.reference_classifier
            and "enhanced_r6d_reference_config" not in cls
        ):
            # remat when the card needs it (classifier_main's rule)
            rargs = argparse.Namespace(**{
                **vars(args), **REFERENCE_CLASSIFIER,
                "classifier_epochs": args.reference_classifier_epochs})
            cls["enhanced_r6d_reference_config"] = stage_classifier(
                "enhanced_refcfg", res_dir, data_dir, model_dir, rargs,
                sel=get_sel(),
            )
            _flush_report(report, args.out)
        if args.anomaly_controls:
            stage_anomaly_controls(cls, work, data_dir, model_dir, args,
                                   sel=get_sel())
            _flush_report(report, args.out)
        if "text_mlp" not in cls:
            cls["text_mlp"] = stage_mlp_classifier(data_dir, model_dir, args)
            _flush_report(report, args.out)

    # Tables 1 and §5.2 are done here; the finger trend below is additive,
    # so a run cut mid-trend still reports the core result
    report["core_completed"] = True
    _flush_report(report, args.out)

    if args.fingers:
        # the incremental finger-masking trend (article Table 2; the
        # launcher sweeps fingers 1..10, launch_exp_incr_fingers.sh:10):
        # one v2+text RobustLoss run per masked-finger count K at
        # --finger_epochs, resumed per K
        ks = _parse_fingers(args.fingers)
        trend = report["finger_trend"] = dict(prior.get("finger_trend", {}))
        report["finger_trend_epochs"] = args.finger_epochs
        targs = argparse.Namespace(**vars(args))
        targs.epochs = args.finger_epochs
        for k in ks:
            key = str(k)
            entry = dict(trend.get(key, {}))
            trend[key] = entry
            cfg = dict(
                name=f"arm_wh2finger{k}_v2_text_RobustLoss_trend",
                model="v2", pipeline=f"arm_wh2finger{k}", loss="RobustLoss",
                require_text=True, learning_rate=1e-3,
            )
            if "train" in entry and not _train_artifacts_ok(model_dir, cfg):
                print(f"[train {cfg['name']}] prior trend entry found but "
                      f"checkpoint/stats files are missing — re-training",
                      flush=True)
                del entry["train"]
                entry.pop("inference", None)
            if "train" not in entry:
                entry["train"] = (
                    _resumed_train(cfg, model_dir, targs.epochs, resumable)
                    or stage_train(cfg, data_dir, model_dir, targs))
                _flush_report(report, args.out)

            def _on_split(res, entry=entry):
                entry["inference"] = res
                _flush_report(report, args.out)

            entry["inference"] = stage_infer(
                cfg, data_dir, model_dir, args,
                prior=entry.get("inference"), on_split=_on_split,
                splits=("val", "test"),
            )
            _flush_report(report, args.out)
        report["finger_trend_vs_article"] = _finger_trend_comparison(trend)
        _flush_report(report, args.out)

    report["completed"] = True
    report["total_wall_s"] = time.perf_counter() - t_total
    _flush_report(report, args.out)
    print(f"\n=== ARTICLE REPLAY DONE in {report['total_wall_s']:.1f}s -> "
          f"{args.out}", flush=True)
    for name, entry in report["configs"].items():
        print(f"  {name}: L1 {entry['inference']['L1']} "
              f"(train {entry['train'].get('wall_s', 0.0):.1f}s)", flush=True)
    if "classifier" in report:
        print(f"  classifier: GT acc "
              f"{report['classifier']['ground_truth_r6d']['best_val_acc']:.3f}"
              f" / enhanced acc "
              f"{report['classifier']['enhanced_r6d']['best_val_acc']:.3f}",
              flush=True)
    return report


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scale", choices=sorted(SCALES), default="article",
                   help="synthetic fixture scale ('article' = the "
                   "published 31,128/1,741/2,322 split sizes)")
    p.add_argument("--data_dir", type=str, default=None,
                   help="existing processed pickles (e.g. real How2Sign); "
                   "skips synthetic fixture generation")
    p.add_argument("--work_dir", type=str, default="article_replay_work_torch")
    p.add_argument("--out", type=str, default="ARTICLE_REPLAY_torch.json")
    p.add_argument("--epochs", type=int, default=200,
                   help="GAN training epochs per config (article: 200)")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--num_samples", type=int, default=3000,
                   help="inference sample cap per split (reference "
                   "inference.py default 3000; its launcher uses 1000; "
                   "-1 = all windows)")
    p.add_argument("--no_epoch_scan", action="store_true",
                   help="feed the training batches from the host instead of "
                   "keeping the dataset on the device")
    p.add_argument("--resume", action="store_true",
                   help="reuse completed stages: prior --out report "
                   "entries, the on-disk synthetic fixture, and finished "
                   "training checkpoints")
    p.add_argument("--skip_raw_smoke", action="store_true")
    p.add_argument("--skip_classifier", action="store_true")
    p.add_argument("--configs", type=str, default="",
                   help="comma list restricting which canonical configs "
                   "run (names from CONFIGS; default: all).  The "
                   "classifier surrogate stage consumes the FIRST "
                   "config's results, so '--configs arm2wh_v1_L1' is "
                   "the minimal classifier-bearing run")
    p.add_argument("--signal_fixture", action="store_true",
                   help="make the synthetic fixture with categ_signal=True "
                   "(label-dependent pose signature and text class "
                   "centroids, data/synthetic.py), so that the classifier "
                   "surrogate eval (§5.2) measures above-chance learning; "
                   "the default fixture's labels are independent of the "
                   "pose streams, so its accuracies sit at chance")
    p.add_argument("--finger_signal", action="store_true",
                   help="make the fixture with finger_signal=True "
                   "(data/synthetic.py): hand channels carry a Markov "
                   "chain over the channel index whose recoverable "
                   "information decays with distance from the nearest "
                   "visible channel, and whose clip-level latents ride "
                   "in the sentence embeddings — the structure the "
                   "masked-finger trend (--fingers) needs to show "
                   "article Table 2's monotone shape")
    p.add_argument("--anomaly_controls", action="store_true",
                   help="also train four ablation classifiers "
                   "(gt_arms_only / gt_hands_only / enhanced_hands_only "
                   "/ gt_arms_only_long at 3x budget) that separate which "
                   "channel stream carries the label signal")
    p.add_argument("--fingers", type=str, default="",
                   help="comma list or range of masked-finger counts for "
                   "the incremental-masking trend (article Table 2 / "
                   "launch_exp_incr_fingers.sh:10), e.g. '1,2,3,4,5' or "
                   "'1..5'; each K trains arm_wh2fingerK (v2+text "
                   "RobustLoss) at --finger_epochs and records val/test L1")
    p.add_argument("--finger_epochs", type=int, default=50)
    # classifier stage defaults are scaled down from the reference's
    # (hidden 1024 x 10 bidir layers x 200 epochs); pass the reference
    # values to reproduce H2Sclassifier/Train_Test/main.py:143-160
    p.add_argument("--classifier_epochs", type=int, default=10)
    p.add_argument("--classifier_batch", type=int, default=128)
    p.add_argument("--classifier_hidden", type=int, default=256)
    p.add_argument("--classifier_layers", type=int, default=2)
    p.add_argument("--classifier_bidir", action="store_true")
    p.add_argument("--reference_classifier", action="store_true",
                   help="also train the enhanced-r6d classifier at the "
                   "reference's own config (hidden 1024 x 10 layers x "
                   "bidir, H2Sclassifier/Train_Test/main.py:143-160) at "
                   "--reference_classifier_epochs")
    p.add_argument("--reference_classifier_epochs", type=int, default=20)
    p.add_argument("--device", type=str, default="cuda", help="'cuda' or 'cpu'")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
