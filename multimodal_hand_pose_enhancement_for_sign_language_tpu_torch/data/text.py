"""Text featurizer: sentence loading, grouping and embeddings.

The port's counterpart of the JAX package's ``data/text.py`` (the
re-design of the reference's proc_text.py, paths as arguments).  Methods:

  * "precomputed"  -- no-op (embeddings come from pickles, the training and
    inference contract),
  * "BERTsentence" -- MiniLM-L6 masked-mean sentence embeddings
    (proc_text.py:94-100),
  * "BERTword"     -- bert-base-uncased, the sum of the last four hidden
    states at 512 tokens (proc_text.py:67-92),
  * "clip"         -- CLIP ViT-B/32's text tower, 77 tokens, pooled at the
    first EOS (proc_text.py:60-65).

With ``weights_path`` (a local Hugging Face snapshot directory) a model
method runs through the port's own towers (``models/text_encoders``),
tokenizers (``data/tokenizers``) and snapshot reader
(``models/hf_snapshot``) on ``device``, TF32 off: no ``transformers``.
Without it, the hub routes of the JAX package (``transformers`` / ``clip``,
which download their weights) run as there.  This module imports no torch
until a model method runs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.openpose import (
    natural_keys,
)

TEXT_BATCH = 64  # sentences a tower forward (the tokenization pads over all of them)


def _group_by_clip(dict_text: dict) -> dict:
    """Concatenate utterance sentences per 11-char video id
    (proc_text.py:28-36)."""
    utterance_ids = sorted(dict_text.keys(), key=natural_keys)
    grouped: dict = {}
    for utt_id in utterance_ids:
        vid = utt_id[:11]
        if vid not in grouped:
            grouped[vid] = dict_text[utt_id].replace("\n", " ")
        else:
            grouped[vid] += dict_text[utt_id].replace("\n", " ")
    return grouped


def load_text(file_path: str, ids, groupByClip: bool = False) -> list:
    """Parse `<id> <sentence>` lines, keep requested ids, sort by id
    (proc_text.py:39-53)."""
    ids = set(ids)
    dict_text = {}
    with open(file_path) as fp:
        for line in fp:
            if not line.strip():
                continue
            utt_id, text = line.split(" ", 1)
            if utt_id in ids:
                dict_text[utt_id] = text
    if groupByClip:
        dict_text = _group_by_clip(dict_text)
    return [v for _, v in sorted(dict_text.items())]


def get_clip_ids(file_path: str) -> list:
    """Ids for which text is available (proc_text.py:104-111)."""
    id_list = []
    with open(file_path) as fp:
        for line in fp:
            if not line.strip():
                continue
            utt_id, _ = line.split(" ", 1)
            id_list.append(utt_id)
    return id_list


def _batched(model, device, *arrays) -> np.ndarray:
    """``model`` over numpy ``arrays`` in row batches of ``TEXT_BATCH`` on
    ``device`` (TF32 off), the results stacked on the host."""
    import torch

    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.infer import (
        conv_matmul_precision,
    )

    outs = []
    with torch.inference_mode(), conv_matmul_precision("float32"):
        for s in range(0, len(arrays[0]), TEXT_BATCH):
            batch = (torch.from_numpy(a[s: s + TEXT_BATCH]).to(device) for a in arrays)
            outs.append(model(*batch).cpu().numpy())
    return np.concatenate(outs)


def _bert_embed(sentence_list, model_dir, mode, device):
    """MiniLM mean-pooled sentence embeddings ('sentence') or bert-base
    last-four-layer word embeddings ('word') through the port's
    ``BertEncoder`` from the snapshot at ``model_dir``."""
    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.tokenizers import (
        WordPieceTokenizer,
    )
    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import (
        text_encoders,
    )

    tok = WordPieceTokenizer.from_dir(model_dir)
    if mode == "word":  # proc_text.py:70-72 pads to max_length=512
        enc = tok(sentence_list, padding="max_length", max_length=512)
    else:
        enc = tok(sentence_list, padding=True)
    model = text_encoders.load_bert(model_dir, device)
    ids, mask = enc["input_ids"], enc["attention_mask"]
    if mode == "word":
        def word(i, m):
            return sum(model(i, m, output_hidden_states=True)[1][-4:])  # proc_text.py:88-92
        return _batched(word, device, ids, mask)
    return _batched(lambda i, m: text_encoders.bert_mean_pool(model(i, m), m),
                    device, ids, mask)


def _clip_embed(sentence_list, model_dir, device):
    """CLIP text embeddings through the port's ``CLIPTextEncoder`` from the
    snapshot at ``model_dir`` (77 tokens, pooled at the tokenizer's EOS)."""
    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.tokenizers import (
        CLIPBPETokenizer,
    )
    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import (
        text_encoders,
    )

    tok = CLIPBPETokenizer.from_dir(model_dir)
    enc = tok(sentence_list, padding="max_length", max_length=77)
    model = text_encoders.load_clip_text(model_dir, tok.eos_token_id, device)
    return _batched(model, device, enc["input_ids"])


def obtain_embeddings(
    file_path: str,
    ids,
    method: str = "BERTsentence",
    groupByClip: bool = False,
    weights_path: Optional[str] = None,
    device="cuda",
) -> Optional[np.ndarray]:
    """Sentence embeddings for each clip (proc_text.py:57-100): None for
    ``"precomputed"``; else (clips, width) float32, or (clips, 512, width)
    for BERTword.

    With ``weights_path`` (a local HF snapshot directory) the port's towers
    run on ``device``; without it, the hub route (downloads; ``transformers``
    or ``clip``)."""
    if method == "precomputed":
        return None
    if method not in ("clip", "BERTword", "BERTsentence"):
        raise ValueError(f"unknown text embedding method {method!r}")
    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.device import (
        resolve_device,
    )

    dev = resolve_device(device)
    sentence_list = load_text(file_path, ids, groupByClip=groupByClip)

    if weights_path is not None:
        if method == "clip":
            return _clip_embed(sentence_list, weights_path, dev)
        mode = "word" if method == "BERTword" else "sentence"
        return _bert_embed(sentence_list, weights_path, mode, dev)
    return _hub_embed(sentence_list, method, dev)


def _hub_embed(sentence_list, method, dev):
    """The hub routes of the JAX package (data/text.py there), on ``dev``."""
    import torch

    if method == "clip":
        import clip

        model, _ = clip.load("ViT-B/32", dev)
        toks = torch.cat([clip.tokenize(s, truncate=True) for s in sentence_list]).to(dev)
        with torch.no_grad():
            return model.encode_text(toks).cpu().numpy()

    if method == "BERTword":
        from transformers import BertModel, BertTokenizer

        tokenizer = BertTokenizer.from_pretrained("bert-base-uncased")
        enc = tokenizer.batch_encode_plus(
            sentence_list,
            add_special_tokens=True,
            padding="max_length",
            max_length=512,
            truncation=True,
            return_tensors="pt",
        )
        model = BertModel.from_pretrained("bert-base-uncased", output_hidden_states=True)
        model.to(dev).eval()
        with torch.no_grad():
            outputs = model(enc["input_ids"].to(dev), enc["attention_mask"].to(dev))
            hidden = outputs[2]
        return torch.sum(torch.stack(hidden[-4:], dim=0), dim=0).cpu().numpy()

    from transformers import AutoModel, AutoTokenizer

    name = "sentence-transformers/paraphrase-MiniLM-L6-v2"
    tokenizer = AutoTokenizer.from_pretrained(name)
    model = AutoModel.from_pretrained(name)
    model.to(dev).eval()
    enc = tokenizer(sentence_list, padding=True, truncation=True, return_tensors="pt")
    with torch.no_grad():
        out = model(**{k: v.to(dev) for k, v in enc.items()})
    # mean pooling with attention mask (what sentence-transformers does)
    mask = enc["attention_mask"].to(dev).unsqueeze(-1).float()
    emb = (out.last_hidden_state * mask).sum(1) / mask.sum(1).clamp(min=1e-9)
    return emb.cpu().numpy()


def average_embeds(embeds) -> np.ndarray:
    """The ``--embeds_type average`` pickle derived from per-clip embeddings:
    the dataset column mean tiled per clip (proc_text.py:133-139 re-runs the
    encoder for it; the mean over the same clip set is the same)."""
    embeds = np.asarray(embeds)
    return np.tile(np.average(embeds, axis=0), (embeds.shape[0], 1))


def obtain_avg_embed(
    file_path: str,
    ids,
    method="BERTsentence",
    subset: float = 1.0,
    weights_path: Optional[str] = None,
    device="cuda",
):
    """Dataset-mean embedding tiled per clip (proc_text.py:133-139)."""
    ids = sorted(ids)
    idx_max = int(len(ids) * subset)
    embeds = obtain_embeddings(
        file_path, ids[:idx_max], method=method, weights_path=weights_path, device=device
    )
    col_mean = np.average(embeds, axis=0)
    return np.tile(col_mean, (embeds.shape[0], 1))
