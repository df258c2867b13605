"""The featurizers' tokenizers, read from a snapshot's vocabulary files.

The JAX package tokenizes through ``transformers.AutoTokenizer``; the port
has its own, so that the text route runs where ``transformers``,
``tokenizers`` and ``regex`` are absent.  Both follow the slow Hugging Face
tokenizers (``BertTokenizer``, and ``CLIPTokenizer`` without ``ftfy``):

  * ``WordPieceTokenizer`` (``vocab.txt`` + ``tokenizer_config.json``):
    BasicTokenizer's clean-up (NUL, U+FFFD and control characters dropped,
    whitespace to spaces), spaces around CJK ideographs, NFC, lower-casing
    with NFD accent stripping, punctuation splitting; then greedy
    longest-match ``##`` pieces, ``[UNK]`` for a word past 100 characters or
    one no piece sequence covers; ``[CLS] ... [SEP]``, truncation, right
    padding with ``[PAD]``, ``token_type_ids`` of zeros.
  * ``CLIPBPETokenizer`` (``vocab.json`` + ``merges.txt``): the same
    clean-up and lower-casing without accent stripping or punctuation
    splitting, CLIP's pre-tokenization (``'s 't 're 've 'm 'll 'd``, runs of
    letters, single digits, runs of anything else), byte-to-unicode, BPE by
    merge rank with ``</w>`` word ends; ``<|startoftext|> ... <|endoftext|>``
    and padding with ``<|endoftext|>``.  CLIP's pattern uses ``regex``'s
    ``\\p{L}`` / ``\\p{N}``, which the standard ``re`` lacks; the
    pre-tokenizer here scans Unicode categories instead (L*, N*).

Both return ``{"input_ids", "attention_mask"[, "token_type_ids"]}`` as int64
numpy arrays.  ``padding=True`` pads to the longest sentence, ``"max_length"``
to ``max_length``; truncation keeps ``max_length`` tokens, specials
included, where ``max_length`` defaults to the config's
``model_max_length``.
"""

from __future__ import annotations

import json
import os
import unicodedata
from functools import lru_cache

import numpy as np

_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))
# the slow tokenizers' merge cap: 49152 - 256 - 2 merges after the version line
CLIP_MAX_MERGES = 49152 - 256 - 2
CLIP_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True  # every non-alphanumeric ASCII character
    return unicodedata.category(ch).startswith("P")


def _strip_accents(text: str) -> str:
    return "".join(c for c in unicodedata.normalize("NFD", text)
                   if unicodedata.category(c) != "Mn")


def _split_on_punc(token: str) -> list:
    out, new_word = [], True
    for ch in token:
        if _is_punctuation(ch):
            out.append(ch)
            new_word = True
        else:
            if new_word:
                out.append("")
            new_word = False
            out[-1] += ch
    return out


def basic_tokenize(text: str, lower: bool = True, strip_accents=None,
                   chinese_chars: bool = True, split_on_punc: bool = True) -> list:
    """HF's BasicTokenizer: ``strip_accents`` None follows ``lower``."""
    text = "".join(" " if _is_whitespace(c) else c for c in text
                   if not (c in "\x00\ufffd" or _is_control(c)))
    if chinese_chars:
        text = "".join(f" {c} " if any(lo <= ord(c) <= hi for lo, hi in _CJK) else c
                       for c in text)
    pieces = []
    for token in unicodedata.normalize("NFC", text).split():
        if lower:
            token = token.lower()
            if strip_accents is not False:
                token = _strip_accents(token)
        elif strip_accents:
            token = _strip_accents(token)
        pieces.extend(_split_on_punc(token) if split_on_punc else [token])
    return " ".join(pieces).split()


def _token_name(value, default):
    """A special token in a tokenizer config: a string, or an AddedToken dict."""
    if value is None:
        return default
    return value["content"] if isinstance(value, dict) else value


def _read_tokenizer_config(model_dir: str) -> dict:
    path = os.path.join(model_dir, "tokenizer_config.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def split_specials(text: str, specials) -> list:
    """Cut ``text`` around every occurrence of a special token (the longest
    at a position), as the slow tokenizers' added-token trie does."""
    out, i, start = [], 0, 0
    while i < len(text):
        hit = max((s for s in specials if text.startswith(s, i)), key=len, default=None)
        if hit is None:
            i += 1
            continue
        if start < i:
            out.append(text[start:i])
        out.append(hit)
        i = start = i + len(hit)
    if start < len(text):
        out.append(text[start:])
    return out


class _Encoder:
    """Special tokens, truncation and padding shared by both tokenizers."""

    specials: tuple
    unk_token_id: int
    bos_token_id: int
    eos_token_id: int
    pad_token_id: int
    model_max_length = None
    type_ids = False

    def _tokenize(self, text: str) -> list:
        raise NotImplementedError

    def _vocab(self) -> dict:
        raise NotImplementedError

    def tokenize(self, text: str) -> list:
        """The tokens of ``text``; special tokens in it stay whole."""
        out = []
        for piece in split_specials(text, self.specials):
            out.extend([piece] if piece in self.specials else self._tokenize(piece))
        return out

    def token_ids(self, text: str) -> list:
        vocab = self._vocab()
        return [vocab.get(t, self.unk_token_id) for t in self.tokenize(text)]

    def __call__(self, sentences, padding=True, truncation=True, max_length=None) -> dict:
        if max_length is None:
            max_length = self.model_max_length
        rows = []
        for s in sentences:
            ids = self.token_ids(s)
            if truncation and max_length is not None:
                ids = ids[: max(max_length - 2, 0)]
            rows.append([self.bos_token_id, *ids, self.eos_token_id])
        if padding == "max_length":
            if max_length is None:
                raise ValueError("padding='max_length' needs max_length or model_max_length")
            width = max([max_length, *map(len, rows)])
        elif padding is True or padding == "longest":
            width = max(map(len, rows), default=0)
        else:
            raise ValueError(f"padding={padding!r}: expected True or 'max_length'")
        ids = np.full((len(rows), width), self.pad_token_id, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        out = {"input_ids": ids, "attention_mask": mask}
        if self.type_ids:
            out["token_type_ids"] = np.zeros_like(ids)
        return out


class WordPieceTokenizer(_Encoder):
    """BERT's tokenizer (``BertTokenizer``) from a vocabulary list."""

    type_ids = True

    def __init__(self, vocab, do_lower_case=True, strip_accents=None,
                 tokenize_chinese_chars=True, model_max_length=None,
                 unk_token="[UNK]", cls_token="[CLS]", sep_token="[SEP]",
                 pad_token="[PAD]", mask_token="[MASK]", max_input_chars_per_word=100):
        self.vocab = {tok: i for i, tok in enumerate(vocab)}
        self.do_lower_case = do_lower_case
        self.strip_accents = strip_accents
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.model_max_length = model_max_length
        self.unk_token = unk_token
        self.specials = (unk_token, cls_token, sep_token, pad_token, mask_token)
        self.unk_token_id = self.vocab[unk_token]
        self.max_input_chars_per_word = max_input_chars_per_word
        self.bos_token_id = self.vocab[cls_token]
        self.eos_token_id = self.vocab[sep_token]
        self.pad_token_id = self.vocab[pad_token]

    @classmethod
    def from_dir(cls, model_dir: str) -> "WordPieceTokenizer":
        """``vocab.txt`` (one token a line) and ``tokenizer_config.json``."""
        with open(os.path.join(model_dir, "vocab.txt"), encoding="utf-8") as f:
            vocab = [line.rstrip("\n") for line in f]
        cfg = _read_tokenizer_config(model_dir)
        return cls(
            vocab,
            do_lower_case=cfg.get("do_lower_case", True),
            strip_accents=cfg.get("strip_accents"),
            tokenize_chinese_chars=cfg.get("tokenize_chinese_chars", True),
            model_max_length=cfg.get("model_max_length"),
            **{k: _token_name(cfg.get(k), d) for k, d in (
                ("unk_token", "[UNK]"), ("cls_token", "[CLS]"), ("sep_token", "[SEP]"),
                ("pad_token", "[PAD]"), ("mask_token", "[MASK]"))},
        )

    def _wordpiece(self, word: str) -> list:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = ("##" if start else "") + word[start:end]
                if piece in self.vocab:
                    break
                end -= 1
            else:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def _tokenize(self, text: str) -> list:
        out = []
        for token in basic_tokenize(text, self.do_lower_case, self.strip_accents,
                                    self.tokenize_chinese_chars):
            out.extend(self._wordpiece(token))
        return out

    def _vocab(self) -> dict:
        return self.vocab


@lru_cache(maxsize=1)
def bytes_to_unicode() -> dict:
    """GPT-2's reversible byte -> printable character map."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _char_class(ch: str) -> str:
    cat = unicodedata.category(ch)
    if cat[0] in "LN":
        return cat[0]
    return "S" if ch.isspace() else "O"


def clip_pretokenize(text: str, specials=("<|startoftext|>", "<|endoftext|>")) -> list:
    """CLIP's pattern ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|
    [\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` (case-insensitive) by a scan of
    Unicode categories: at each position the first alternative that matches
    wins, as in the regular expression."""
    out, i, n = [], 0, len(text)
    while i < n:
        low = text[i: i + 3].lower()
        hit = next((s for s in specials if text.startswith(s, i)), None)
        if hit is None:
            hit = next((text[i: i + len(c)] for c in CLIP_CONTRACTIONS
                        if low.startswith(c)), None)
        if hit is not None:
            out.append(hit)
            i += len(hit)
            continue
        cls = _char_class(text[i])
        j = i + 1
        if cls == "L":
            while j < n and _char_class(text[j]) == "L":
                j += 1
        elif cls == "O":
            while j < n and _char_class(text[j]) == "O":
                j += 1
        if cls != "S":
            out.append(text[i:j])
        i = j
    return out


class CLIPBPETokenizer(_Encoder):
    """CLIP's byte-level BPE tokenizer (``CLIPTokenizer`` without ftfy)."""

    def __init__(self, encoder: dict, merges, model_max_length=None,
                 bos_token="<|startoftext|>", eos_token="<|endoftext|>",
                 pad_token="<|endoftext|>", unk_token="<|endoftext|>"):
        self.encoder = dict(encoder)
        self.bpe_ranks = {tuple(m): r for r, m in enumerate(merges[:CLIP_MAX_MERGES])}
        self.model_max_length = model_max_length
        self.specials = tuple(dict.fromkeys((bos_token, eos_token, pad_token, unk_token)))
        self.byte_encoder = bytes_to_unicode()
        self.unk_token_id = self.encoder[unk_token]
        self.bos_token_id = self.encoder[bos_token]
        self.eos_token_id = self.encoder[eos_token]
        self.pad_token_id = self.encoder[pad_token]
        self._cache: dict = {}

    @classmethod
    def from_dir(cls, model_dir: str) -> "CLIPBPETokenizer":
        """``vocab.json``, ``merges.txt`` (a version line, then one merge a
        line) and ``tokenizer_config.json``."""
        with open(os.path.join(model_dir, "vocab.json"), encoding="utf-8") as f:
            encoder = json.load(f)
        with open(os.path.join(model_dir, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1:]
        cfg = _read_tokenizer_config(model_dir)
        return cls(
            encoder, [tuple(m.split()) for m in lines],
            model_max_length=cfg.get("model_max_length"),
            **{k: _token_name(cfg.get(k), d) for k, d in (
                ("bos_token", "<|startoftext|>"), ("eos_token", "<|endoftext|>"),
                ("pad_token", "<|endoftext|>"), ("unk_token", "<|endoftext|>"))},
        )

    def bpe(self, token: str) -> list:
        """Merge the lowest-ranked adjacent pair until none is ranked."""
        if token in self._cache:
            return self._cache[token]
        word = (*token[:-1], token[-1] + "</w>")
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self._cache[token] = list(word)
        return self._cache[token]

    def _tokenize(self, text: str) -> list:
        out = []
        text = " ".join(basic_tokenize(text, lower=True, strip_accents=False,
                                       split_on_punc=False))
        for piece in clip_pretokenize(text, self.specials):
            if piece in self.specials:  # lower-cased into a special, as HF's pattern finds it
                out.append(piece)
            else:
                out.extend(self.bpe("".join(self.byte_encoder[b] for b in piece.encode("utf-8"))))
        return out

    def _vocab(self) -> dict:
        return self.encoder
