"""Tokenizers: a verbatim copy of ``docqa_tpu/text/tokenizer.py``
(``Tokenizer``, ``HashTokenizer``, the NER tagger's ``ShapeHashTokenizer``
and ``WordPieceTokenizer``), so token ids match the reference bit for bit.
The hash tokenizers map a word to a stable FNV-1a bucket and need no
vocabulary file; ``WordPieceTokenizer`` reads a BERT ``vocab.txt``, and
:func:`default_tokenizer` hands ``tokenizer.json`` / ``*.model`` files to
``text/bpe.py``.

Output contract: right-padded ``ids [batch, max_len]`` plus ``lengths
[batch]`` — the padding convention the attention ``lengths`` masks expect.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

PAD, UNK, CLS, SEP, MASK = 0, 1, 2, 3, 4
_SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]

_WORD_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)


def _fnv1a(s: str) -> int:
    h = 0xCBF29CE484222325
    for byte in s.encode("utf-8"):
        h ^= byte
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class Tokenizer:
    """Base: whitespace/punct pre-tokenization + subclass word→ids."""

    pad_id = PAD
    unk_id = UNK
    cls_id = CLS
    sep_id = SEP

    def __init__(self, vocab_size: int, lowercase: bool = True):
        self.vocab_size = vocab_size
        self.lowercase = lowercase

    def pre_tokenize(self, text: str) -> List[str]:
        if self.lowercase:
            text = text.lower()
        return _WORD_RE.findall(text)

    def word_to_ids(self, word: str) -> List[int]:
        raise NotImplementedError

    def encode(
        self, text: str, max_len: Optional[int] = None, add_specials: bool = True
    ) -> List[int]:
        ids: List[int] = [self.cls_id] if add_specials else []
        budget = None if max_len is None else max_len - (2 if add_specials else 0)
        for word in self.pre_tokenize(text):
            wids = self.word_to_ids(word)
            if budget is not None and len(ids) - (1 if add_specials else 0) + len(
                wids
            ) > budget:
                break
            ids.extend(wids)
        if add_specials:
            ids.append(self.sep_id)
        return ids

    def decode_ids(self, ids: Sequence[int]) -> str:
        """Best-effort detokenization (skips specials, merges wordpieces)."""
        inv = getattr(self, "_inv_vocab", None)
        if inv is None:
            return " ".join(f"w{i}" for i in ids)
        pieces: List[str] = []
        for i in ids:
            tok = inv.get(int(i))
            if tok is None or tok in _SPECIALS:
                continue
            if tok.startswith("##") and pieces:
                pieces[-1] += tok[2:]
            else:
                pieces.append(tok)
        return " ".join(pieces)

    def batch(
        self,
        texts: Sequence[str],
        max_len: int,
        add_specials: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Right-padded [batch, max_len] int32 ids + [batch] lengths."""
        rows = [self.encode(t, max_len, add_specials) for t in texts]
        out = np.full((len(rows), max_len), self.pad_id, np.int32)
        lengths = np.zeros((len(rows),), np.int32)
        for i, row in enumerate(rows):
            row = row[:max_len]
            out[i, : len(row)] = row
            lengths[i] = len(row)
        return out, lengths


class HashTokenizer(Tokenizer):
    """Deterministic hash-bucket tokenizer (no vocabulary file needed)."""

    def __init__(self, vocab_size: int = 30522, lowercase: bool = True):
        super().__init__(vocab_size, lowercase)
        self._n_reserved = len(_SPECIALS)

    def word_to_ids(self, word: str) -> List[int]:
        bucket = self._n_reserved + _fnv1a(word) % (
            self.vocab_size - self._n_reserved
        )
        return [int(bucket)]


class ShapeHashTokenizer(HashTokenizer):
    """Hash tokenizer that preserves orthographic shape for NER.

    PHI detection hinges on casing — "Boston" vs "boston" — but an unseen
    name hashes to a bucket whose embedding carries no case information.  So
    each word is emitted as ``[shape_marker?, bucket]``: a TITLE / ALLCAPS /
    HAS-DIGIT marker token (when the word has a notable shape) followed by
    the case-insensitive hash bucket.

    ``lowercase=False`` so callers (``deid/engine.py``) pass words through
    with case intact; the bucket itself is computed case-insensitively.
    """

    SHAPE_TITLE, SHAPE_UPPER, SHAPE_DIGIT = 5, 6, 7

    def __init__(self, vocab_size: int = 30522):
        super().__init__(vocab_size, lowercase=False)
        self._n_reserved = 8  # 5 specials + 3 shape markers

    def _shape(self, word: str) -> Optional[int]:
        if any(c.isdigit() for c in word):
            return self.SHAPE_DIGIT
        if len(word) > 1 and word.isupper():
            return self.SHAPE_UPPER
        if word[:1].isupper():
            return self.SHAPE_TITLE
        return None

    def word_to_ids(self, word: str) -> List[int]:
        bucket = self._n_reserved + _fnv1a(word.lower()) % (
            self.vocab_size - self._n_reserved
        )
        shape = self._shape(word)
        return [bucket] if shape is None else [shape, int(bucket)]


class WordPieceTokenizer(Tokenizer):
    """Greedy longest-match-first WordPiece over a BERT ``vocab.txt``."""

    def __init__(
        self,
        vocab: Sequence[str],
        lowercase: bool = True,
        max_word_chars: int = 100,
    ):
        super().__init__(len(vocab), lowercase)
        self.vocab = {tok: i for i, tok in enumerate(vocab)}
        self._inv_vocab = {i: tok for tok, i in self.vocab.items()}
        self.max_word_chars = max_word_chars
        for name, attr in (
            ("[PAD]", "pad_id"),
            ("[UNK]", "unk_id"),
            ("[CLS]", "cls_id"),
            ("[SEP]", "sep_id"),
        ):
            if name in self.vocab:
                setattr(self, attr, self.vocab[name])

    @classmethod
    def from_file(cls, path: str, **kwargs) -> "WordPieceTokenizer":
        with open(path, encoding="utf-8") as f:
            vocab = [line.rstrip("\n") for line in f]
        return cls(vocab, **kwargs)

    def word_to_ids(self, word: str) -> List[int]:
        if len(word) > self.max_word_chars:
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece_id = None
            while end > start:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    piece_id = self.vocab[piece]
                    break
                end -= 1
            if piece_id is None:
                return [self.unk_id]
            ids.append(piece_id)
            start = end
        return ids


def default_tokenizer(
    vocab_size: int = 30522, vocab_path: Optional[str] = None
) -> Tokenizer:
    """The real vocabulary when a file is given, else the hash fallback.
    Dispatch: ``*.txt`` -> WordPiece, ``tokenizer.json`` -> byte-level or
    metaspace BPE, ``*.model`` -> SentencePiece (``text/bpe.py``)."""
    if vocab_path:
        if vocab_path.endswith((".json", ".model")):
            from docqa_tpu_torch.text.bpe import load_tokenizer

            return load_tokenizer(vocab_path)
        return WordPieceTokenizer.from_file(vocab_path)
    return HashTokenizer(vocab_size)
