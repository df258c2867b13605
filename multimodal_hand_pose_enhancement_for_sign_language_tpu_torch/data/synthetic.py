"""Deterministic synthetic How2Sign-like fixtures.

The port's copy of the JAX package's ``data/synthetic.py``, built on the
port's own geometry (``ops/{kinematics,rotations}``) and pickles
(``data/io``).  The reference hard-codes cluster dataset paths
(proc_text.py:9-13, proc_vid.py:16-26, proc_categ.py:6-12), so a fake-data
generator is the only way to exercise the pipeline hermetically:

  * ``make_openpose_tree``   -- raw-format fixture: OpenPose per-frame JSON
    directories + `<id> <sentence>` text files + videoID,categoryID CSVs,
    laid out exactly like the How2Sign utterance-level release.
  * ``make_r6d_dataset``     -- processed-format fixture: the pickles the
    training/inference entry points consume (r6d_{set}.pkl, xyz_{set}.pkl,
    {set}_sentence_embeddings.pkl, {set}_vid_feats.pkl, categs_{set}.pkl),
    generated through the port's geometry ops so they are mutually
    consistent (r6d <-> aa <-> xyz).  Its FK, IK and r6d conversion run on
    ``device``; the categories and the embeddings are numpy's alone, equal
    to the JAX package's for the same seed.
  * ``make_video_tree``      -- an .mp4 per utterance of an OpenPose tree
    (needs cv2), the same frames as the JAX package's for the same seed.
  * ``write_bert_snapshot`` / ``write_clip_snapshot`` /
    ``write_resnet50_weights`` -- featurizer weights with seeded random
    values at any width, written as a local Hugging Face snapshot
    (config.json, the tokenizer's vocabulary files, ``pytorch_model.bin``)
    or a torchvision ``.pth``, without ``transformers``; the vocabularies
    (``bert_vocab``, ``clip_bpe_vocab``) cover the given sentences.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.io import save_binary
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import (
    kinematics,
    rotations,
    skeleton,
)

SPLITS = ("train", "val", "test")


def _utt_id(video_idx: int, utt_idx: int) -> str:
    # first 11 characters form the video id (utils/utils.py:180)
    return f"vid{video_idx:08d}-{utt_idx}-rgb_front"


def make_openpose_tree(
    root: str,
    n_videos: int = 2,
    utts_per_video: int = 2,
    frames: int = 8,
    seed: int = 0,
    videos=None,
    splits=SPLITS,
):
    """Write a raw OpenPose-format dataset under `root`.

    Each of ``splits`` gets ``n_videos`` videos of ``utts_per_video``
    utterances of ``frames`` frames, or, with ``videos`` (a list of
    utterance counts), one video per entry.  The same arguments draw the
    JAX package's tree.  Frames are drawn in order here and written by a
    few threads, an utterance at a time (file creation, not the draws, is
    the cost of a large tree).  Returns dict with 'dataset_path',
    'text_paths', 'categ_paths'.
    """
    rng = np.random.RandomState(seed)
    if videos is None:
        videos = [utts_per_video] * n_videos
    text_paths, categ_paths = {}, {}
    with ThreadPoolExecutor(max_workers=8) as writers:
        pending = []
        for split in splits:
            json_root = os.path.join(
                root, split, "rgb_front", "features", "openpose_output", "json"
            )
            os.makedirs(json_root, exist_ok=True)
            lines = []
            categ_rows = ["videoID,categoryID"]
            for v, n_utts in enumerate(videos):
                vid = _utt_id(v, 0)[:11]
                categ_rows.append(f"{vid},{1 + (v % 9)}")
                for u in range(n_utts):
                    uid = _utt_id(v, u)
                    utt_dir = os.path.join(json_root, uid)
                    os.makedirs(utt_dir, exist_ok=True)
                    lines.append(f"{uid} synthetic sentence about topic {v}.")
                    files = [(os.path.join(utt_dir, f"{uid}_{t:012d}_keypoints.json"),
                              json.dumps(_frame(rng))) for t in range(frames)]
                    pending.append(writers.submit(_write_all, files))
            text_path = os.path.join(root, f"{split}.text.id.en")
            with open(text_path, "w") as f:
                f.write("\n".join(lines) + "\n")
            text_paths[split] = text_path
            categ_path = os.path.join(root, f"videoID_categoryID_{split}.csv")
            with open(categ_path, "w") as f:
                f.write("\n".join(categ_rows) + "\n")
            categ_paths[split] = categ_path
        for job in pending:
            job.result()  # re-raise a failed write
    return {
        "dataset_path": root,
        "text_paths": text_paths,
        "categ_paths": categ_paths,
    }


def _frame(rng) -> dict:
    """One OpenPose frame: BODY_25 and two hands of (x, y, confidence)."""
    body = rng.uniform(100, 500, size=25 * 3)
    body[2::3] = rng.uniform(0.5, 1.0, size=25)
    rh = rng.uniform(100, 500, size=21 * 3)
    rh[2::3] = rng.uniform(0.5, 1.0, size=21)
    lh = rng.uniform(100, 500, size=21 * 3)
    lh[2::3] = rng.uniform(0.5, 1.0, size=21)
    return {
        "people": [
            {
                "pose_keypoints_2d": body.tolist(),
                "hand_right_keypoints_2d": rh.tolist(),
                "hand_left_keypoints_2d": lh.tolist(),
            }
        ]
    }


def _write_all(files) -> None:
    for path, text in files:
        with open(path, "w") as f:
            f.write(text)


# --- finger_signal chain constants (see make_r6d_dataset docstring) ---
_N_HAND_AA = 126  # 42 hand bones x 3 aa channels (cols 18..144)
_CHAIN_RHO = 0.985  # per-channel-step correlation: info decays ~rho^d
_CHAIN_ALPHA = 0.6  # innovation share that is text-predictable


def _finger_chain(frng, T):
    """One clip's hand-channel Markov chain (T, 126) plus the clip-level
    latent parameters theta (27,) that the text embeddings carry.

    All series have marginal variance ~0.5 (unit-amplitude sinusoids
    with uniform random phase), so the chain is variance-stationary:
    the conditional std of channel j given the nearest visible channel
    at distance d is sqrt(1 - rho^(2d)) of its marginal std -- the
    monotone-in-d error floor the finger-masking trend measures."""
    t = np.arange(T, dtype=np.float64)[:, None]
    a = frng.uniform(0.7, 1.3, size=6)
    w = frng.uniform(0.05, 0.45, size=6)
    p = frng.uniform(0, 2 * np.pi, size=6)
    wu = frng.uniform(0.1, 0.5)
    pu = frng.uniform(0, 2 * np.pi)
    we = frng.uniform(0.05, 0.6, size=_N_HAND_AA)
    pe = frng.uniform(0, 2 * np.pi, size=_N_HAND_AA)
    z = a * np.sin(w * t + p)  # (T, 6) smooth per-clip latent driver
    s = z.sum(axis=1) / np.sqrt(6.0)  # chain root, var ~ 0.5
    j = np.arange(_N_HAND_AA, dtype=np.float64)
    u = np.sin(wu * t + pu + 0.35 * j)  # text-predictable innovations
    eta = np.sin(we * t + pe)  # private per-channel noise
    innov = _CHAIN_ALPHA * u + np.sqrt(1.0 - _CHAIN_ALPHA**2) * eta
    c = np.sqrt(1.0 - _CHAIN_RHO**2)
    S = np.empty((T, _N_HAND_AA))
    for jj in range(_N_HAND_AA):
        s = _CHAIN_RHO * s + c * innov[:, jj]
        S[:, jj] = s
    theta = np.concatenate(
        [
            (a - 1.0) / 0.3,
            (w - 0.25) / 0.2,
            np.sin(p),
            np.cos(p),
            [(wu - 0.3) / 0.2, np.sin(pu), np.cos(pu)],
        ]
    )
    return S, theta


def make_r6d_dataset(
    data_dir: str,
    n_clips: int = 6,
    t_range: tuple[int, int] = (40, 240),
    seed: int = 0,
    text_dim: int = 512,
    image_dim: int = 2000,
    split_counts: dict | None = None,
    save_image_feats: bool = True,
    ik_roundtrip: bool = True,
    categ_signal: bool = False,
    finger_signal: bool = False,
    device="cuda",
):
    """Write processed pickles for all three splits under `data_dir`.

    The r6d data is geometrically valid: random smooth axis-angle curves
    run through FK to xyz, back through IK to aa, then to r6d — matching
    what the real pipeline produces.

    `split_counts` overrides the per-split clip counts (e.g. the article
    scale {'train': 31128, 'val': 1741, 'test': 2322}, §5 of the PDF);
    `save_image_feats=False` skips the (T, image_dim) per-clip
    ResNet-feature pickles, which dominate disk at article scale.
    `ik_roundtrip=False` skips the IK pass: the r6d then comes from the
    drawn angles themselves (xyz == FK(aa) holds either way).

    By default the categoryID labels (`1 + i % 9`) carry no information
    about the pose/text content (so classifier accuracy on the fixture is
    chance — the honest default for plumbing tests).  `categ_signal=True`
    makes the labels learnable: each class k adds a distinct per-frame
    angular oscillation frequency to the axis-angle curves (which survives
    the FK→IK→r6d round trip into the classifier's input windows) and a
    class centroid to the sentence embeddings — so the downstream LSTM /
    text-MLP surrogate evaluation (article §5.2,
    H2Sclassifier/Train_Test/main.py:23-121) can be
    tested for actual above-chance learning, not just plumbing.  The
    default-False path consumes the RNG identically with or without this
    flag, so existing fixtures stay byte-identical.

    `finger_signal=True` gives the HAND channels the information
    structure the incremental finger-masking experiment (article Table 2,
    launch_exp_incr_fingers.sh:10) needs to show its monotone
    degradation: each hand aa-channel j carries a stationary Markov chain
    over the channel index,

        s_j(t) = rho * s_{j-1}(t) + sqrt(1-rho^2) * innov_j(t),

    rooted in a per-clip smooth latent whose parameters are also linearly
    embedded into the sentence embeddings (so text conditioning helps),
    with innovations split between a text-predictable component and
    private per-channel noise.  arm_wh2fingerK masks the last 4K hand
    bones, and the chain's information decays geometrically with distance
    from the nearest visible channel, so the best masked-channel L1 rises
    strictly with K: Table 2's shape.  Hand-channel amplitudes keep
    per-bone axis-angle norms under pi (the aa -> r6d map is injective
    only there).  It draws only from side streams, so the other options'
    fixtures stay byte-identical.

    The FK, IK and r6d conversions run on ``device``; everything else is
    numpy's alone, equal to the JAX package's for the same arguments.
    """
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    root = np.array([0.0, 0.0, 0.0, 0.0, 1.0, 0.0], dtype=np.float32)
    bone_len = rng.uniform(0.5, 1.5, size=(skeleton.N_BONES,)).astype(np.float32)

    out = {}
    for split in SPLITS:
        if split_counts is not None:
            n = int(split_counts[split])
        else:
            n = n_clips if split == "train" else max(2, n_clips // 2)
        frng = (
            np.random.RandomState(seed * 1000003 + 9100 + SPLITS.index(split))
            if finger_signal
            else None
        )
        thetas = []
        aa_clips = []
        for i in range(n):
            T = int(rng.randint(*t_range))
            base = rng.uniform(0.3, 1.0, size=(1, 144))
            wob = 0.1 * np.sin(
                np.linspace(0, 6, T)[:, None] + rng.uniform(0, 3, size=(1, 144))
            )
            clip = base + wob
            csig = None
            if categ_signal:
                # class k's signature: a per-class mean angular offset
                # (readable at any timestep) plus a distinct per-frame
                # oscillation frequency (periods ~5..23 frames, well
                # inside one 192-frame classifier window), on every joint
                # channel; deterministic in k, so the main RNG stream is
                # untouched
                k = 1 + (i % 9)
                omega = 0.15 + 0.12 * k
                t = np.arange(T, dtype=np.float64)[:, None]
                c = np.arange(144, dtype=np.float64)[None, :]
                csig = 0.08 * k + 0.35 * np.sin(omega * t + 0.5 * c)
            if finger_signal:
                S, theta = _finger_chain(frng, T)
                thetas.append(theta)
                # hand channels (bones 6..47 -> aa cols 18..144): damped
                # base/wob plus the chain; the arm channels (cols 0..18)
                # keep the full class signature, so the classifier
                # surrogate stays discriminative
                clip[:, 18:] = (
                    0.25 * base[:, 18:] + 0.5 * wob[:, 18:] + 0.8 * S
                )
                if csig is not None:
                    csig = csig * np.concatenate(
                        [np.ones(18), np.full(_N_HAND_AA, 0.35)]
                    )[None, :]
            if csig is not None:
                clip = clip + csig
            aa_clips.append(clip.astype(np.float32))
        xyz = kinematics.aa_to_xyz(aa_clips, root, bone_len, device=device)
        # IK's canonical angles, as the real pipeline's xyz->aa produces them
        aa_final = kinematics.xyz_to_aa(xyz, device=device) if ik_roundtrip else aa_clips
        r6d = rotations.aa_to_rot6d(aa_final, device=device)
        save_binary(r6d, os.path.join(data_dir, f"r6d_{split}.pkl"))
        save_binary(xyz, os.path.join(data_dir, f"xyz_{split}.pkl"))

        embeds = rng.randn(n, text_dim).astype(np.float32)
        if categ_signal:
            # class centroids from a fixed side-stream (the main RNG is
            # not consumed), strong enough for a linear probe / the
            # SentenceClassifier MLP to separate
            cents = np.random.RandomState(seed + 4242).randn(9, text_dim)
            embeds = embeds + 2.0 * cents[
                np.arange(n) % 9
            ].astype(np.float32)
        if finger_signal:
            # the chain's clip-level latent parameters ride in the text
            # embeddings through a fixed projection (side-stream RNG), so
            # text conditioning carries finger-channel information
            proj = np.random.RandomState(seed + 5151).randn(27, text_dim)
            proj /= np.sqrt(27.0)
            embeds = embeds + 1.5 * (np.stack(thetas) @ proj).astype(np.float32)
        save_binary(embeds, os.path.join(data_dir, f"{split}_sentence_embeddings.pkl"))
        save_binary(
            np.tile(embeds.mean(axis=0), (n, 1)),
            os.path.join(data_dir, f"average_{split}_sentence_embeddings.pkl"),
        )
        if save_image_feats:
            feats = [
                rng.randn(c.shape[0], image_dim).astype(np.float32)
                for c in r6d
            ]
            save_binary(
                feats, os.path.join(data_dir, f"{split}_vid_feats.pkl")
            )
        categs = [1 + (i % 9) for i in range(n)]
        save_binary(categs, os.path.join(data_dir, f"categs_{split}.pkl"))
        out[split] = dict(n=n)
    return out


def write_float64_r6d(data_dir: str, seed: int = 0, lengths=((100, 60), (80,))) -> str:
    """r6d_train / r6d_val pickles of seeded float64 (T, 288) clips (numpy's
    RandomState, so every machine writes the same bytes), the first train
    clip with a NaN frame: the input of ``train/data.load_data``'s route for
    clips that are not float32.  ``lengths``: the train and the val clips'
    frame counts."""
    rng = np.random.RandomState(seed)
    os.makedirs(data_dir, exist_ok=True)
    for split, lens in zip(("train", "val"), lengths):
        clips = [0.5 * rng.randn(T, 288) for T in lens]
        if split == "train":
            clips[0][lens[0] // 2, 7] = np.nan
        save_binary(clips, os.path.join(data_dir, f"r6d_{split}"))
    return data_dir


def make_video_tree(root: str, height: int = 360, width: int = 480, seed: int = 0):
    """Write a tiny .mp4 per utterance of an existing OpenPose tree (layout
    ``{split}/rgb_front/raw_videos/{utt_id}.mp4``, the reference's VID_PATHS,
    proc_vid.py:16-26), one random frame per JSON frame.  Needs cv2."""
    import cv2

    rng = np.random.RandomState(seed)
    out = {}
    for split in SPLITS:
        json_root = os.path.join(root, split, "rgb_front", "features", "openpose_output", "json")
        vid_dir = os.path.join(root, split, "rgb_front", "raw_videos")
        os.makedirs(vid_dir, exist_ok=True)
        ids = sorted(os.listdir(json_root)) if os.path.isdir(json_root) else []
        for uid in ids:
            n_frames = len(os.listdir(os.path.join(json_root, uid)))
            writer = cv2.VideoWriter(os.path.join(vid_dir, uid + ".mp4"),
                                     cv2.VideoWriter_fourcc(*"mp4v"), 24.0, (width, height))
            for _ in range(n_frames):
                writer.write(rng.randint(0, 255, size=(height, width, 3), dtype=np.uint8))
            writer.release()
        out[split] = vid_dir
    return out


# --- featurizer snapshots (no transformers needed) ---

BERT_SPECIALS = ("[PAD]", *(f"[unused{i}]" for i in range(99)), "[UNK]", "[CLS]", "[SEP]",
                 "[MASK]")  # bert-base-uncased's ids 0-103


def bert_vocab(sentences, size=None) -> list:
    """A WordPiece vocabulary laid out as bert-base-uncased's: the specials
    at ids 0-103, every character of the (lower-cased, accent-stripped)
    sentences with its ``##`` form, every other word whole, the rest as a
    head and a ``##`` tail (so they split), padded with ``[unused]``
    entries to ``size``."""
    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.tokenizers import (
        basic_tokenize,
    )

    words = sorted({w for s in sentences for w in basic_tokenize(s)})
    chars = sorted({c for w in words for c in w})
    pieces = [*chars, *(f"##{c}" for c in chars)]
    for i, w in enumerate(words):
        half = max(len(w) // 2, 1)
        pieces += [w] if i % 2 == 0 else [w[:half], f"##{w[half:]}"]
    vocab = list(dict.fromkeys([*BERT_SPECIALS, *pieces]))
    if size is not None:
        if size < len(vocab):
            raise ValueError(f"size {size} < the {len(vocab)} tokens the sentences need")
        vocab += [f"[unused{i}]" for i in range(99, 99 + size - len(vocab))]
    return vocab


def clip_bpe_vocab(sentences, n_merges: int = 200):
    """A byte-level BPE vocabulary as CLIP's is laid out: the 256 byte
    symbols, their ``</w>`` forms, the merges learned on the sentences'
    words (the most frequent adjacent pair first, ties by the larger pair)
    with their merged symbols, then ``<|startoftext|>`` and
    ``<|endoftext|>`` last.  Returns (encoder dict, merges list)."""
    from collections import Counter

    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.tokenizers import (
        basic_tokenize,
        bytes_to_unicode,
        clip_pretokenize,
    )

    byte_enc = bytes_to_unicode()
    symbols = list(byte_enc.values())
    vocab = [*symbols, *(f"{c}</w>" for c in symbols)]
    words: Counter = Counter()
    for s in sentences:
        text = " ".join(basic_tokenize(s, strip_accents=False, split_on_punc=False))
        for piece in clip_pretokenize(text):
            enc = [byte_enc[b] for b in piece.encode("utf-8")]
            words[(*enc[:-1], enc[-1] + "</w>")] += 1
    merges = []
    for _ in range(n_merges):
        pairs: Counter = Counter()
        for w, n in words.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += n
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        vocab.append(best[0] + best[1])
        merged: Counter = Counter()
        for w, n in words.items():
            out, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += n
        words = merged
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    return {tok: i for i, tok in enumerate(dict.fromkeys(vocab))}, merges


def _write_json(path, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def write_bert_snapshot(model_dir: str, sentences, hidden_size=384, num_layers=6,
                        num_heads=12, intermediate_size=1536, max_position=512,
                        vocab_size=None, seed=0) -> str:
    """A BertModel snapshot with seeded random weights (HF's init): config.json,
    vocab.txt (``bert_vocab`` of ``sentences``, ``vocab_size`` entries),
    tokenizer_config.json (lower-casing, ``model_max_length`` = positions)
    and pytorch_model.bin in HF's keys."""
    import torch

    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import (
        text_encoders,
    )

    os.makedirs(model_dir, exist_ok=True)
    vocab = bert_vocab(sentences, vocab_size)
    with open(os.path.join(model_dir, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    _write_json(os.path.join(model_dir, "tokenizer_config.json"),
                {"do_lower_case": True, "model_max_length": max_position})
    _write_json(os.path.join(model_dir, "config.json"), {
        "architectures": ["BertModel"], "model_type": "bert", "vocab_size": len(vocab),
        "hidden_size": hidden_size, "num_hidden_layers": num_layers,
        "num_attention_heads": num_heads, "intermediate_size": intermediate_size,
        "max_position_embeddings": max_position, "type_vocab_size": 2,
        "hidden_act": "gelu", "layer_norm_eps": 1e-12})
    net = text_encoders.materialize(
        lambda: text_encoders.BertEncoder(len(vocab), hidden_size, num_layers, num_heads,
                                          intermediate_size, max_position),
        "cpu", generator=torch.Generator().manual_seed(seed))
    torch.save(net.state_dict(), os.path.join(model_dir, "pytorch_model.bin"))
    return model_dir


def write_clip_snapshot(model_dir: str, sentences, text=None, vision=None,
                        projection_dim=512, n_merges=200, seed=0) -> str:
    """A full CLIPModel snapshot with seeded random weights: config.json
    (``text_config``, ``vision_config``, ``projection_dim``), vocab.json
    and merges.txt (``clip_bpe_vocab`` of ``sentences``),
    tokenizer_config.json (``model_max_length`` 77 or the text positions)
    and pytorch_model.bin in HF's keys.  ``text`` / ``vision`` override the
    ViT-B/32 widths (the text tower's vocabulary is at least the
    tokenizer's)."""
    import torch

    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import (
        clip_vision,
        text_encoders,
    )

    encoder, merges = clip_bpe_vocab(sentences, n_merges)
    t = {**dict(vocab_size=49408, hidden_size=512, num_hidden_layers=12, num_attention_heads=8,
                intermediate_size=2048, max_position_embeddings=77), **(text or {})}
    t["vocab_size"] = max(t["vocab_size"], len(encoder))
    v = {**dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                intermediate_size=3072, image_size=224, patch_size=32), **(vision or {})}
    os.makedirs(model_dir, exist_ok=True)
    _write_json(os.path.join(model_dir, "vocab.json"), encoder)
    with open(os.path.join(model_dir, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    _write_json(os.path.join(model_dir, "tokenizer_config.json"),
                {"model_max_length": t["max_position_embeddings"]})
    _write_json(os.path.join(model_dir, "config.json"), {
        "architectures": ["CLIPModel"], "model_type": "clip", "projection_dim": projection_dim,
        "text_config": {**t, "eos_token_id": encoder["<|endoftext|>"]}, "vision_config": v})
    gen = torch.Generator().manual_seed(seed)
    text_net = text_encoders.materialize(lambda: text_encoders.CLIPTextEncoder(
        t["vocab_size"], t["hidden_size"], t["num_hidden_layers"], t["num_attention_heads"],
        t["intermediate_size"], t["max_position_embeddings"], projection_dim), "cpu",
        generator=gen)
    vision_net = text_encoders.materialize(lambda: clip_vision.CLIPVisionEncoder(
        v["hidden_size"], v["num_hidden_layers"], v["num_attention_heads"],
        v["intermediate_size"], v["image_size"], v["patch_size"], projection_dim), "cpu",
        generator=gen)
    sd = {**text_net.state_dict(), **vision_net.state_dict(),
          "logit_scale": torch.tensor(2.6592)}
    torch.save(sd, os.path.join(model_dir, "pytorch_model.bin"))
    return model_dir


def write_resnet50_weights(path: str, seed=0) -> str:
    """A torchvision-layout ResNet-50 ``.pth``: torchvision's init from
    ``seed``, then BatchNorm affine parameters and running statistics drawn
    too (so eval mode is no identity)."""
    import torch

    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import resnet

    gen = torch.Generator().manual_seed(seed)
    net = resnet.load_resnet50(None, device="cpu", generator=gen)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(0.5 + torch.rand(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
    torch.save(net.state_dict(), path)
    return path
