"""Byte-level BPE and SentencePiece tokenizers for real checkpoints: the
port's own copy of ``docqa_tpu/text/bpe.py`` (the port imports nothing of
the reference package), equal to it id for id and in decoded text.

* :class:`BPETokenizer` — merge-ranked BPE over an HF ``tokenizer.json``
  (:meth:`BPETokenizer.from_tokenizer_json`), in two modes detected from
  the file: ``byte_level`` (GPT-2 lineage: BART/RoBERTa; the GPT-2
  pre-token scanner, UTF-8 bytes mapped to a printable alphabet, ranked
  merges) and ``metaspace`` (Llama/Mistral exports: ``" " -> "▁"`` with a
  dummy prefix, ``<0xNN>`` byte fallback).
* :class:`SentencePieceTokenizer` — a raw ``tokenizer.model`` protobuf read
  by a self-contained wire-format parser: BPE models merge the best-scoring
  adjacent pair, unigram models take the Viterbi segmentation.

Both are pure Python: neither the ``tokenizers`` nor the ``sentencepiece``
package is needed (the card's machine has neither).  ``load_tokenizer``
dispatches on the file: ``*.json`` -> BPE, ``*.model`` -> SentencePiece,
``*.txt`` -> WordPiece.
"""

from __future__ import annotations

import json
import re
import struct
from typing import Dict, List, Optional, Sequence, Tuple

from docqa_tpu_torch.text.tokenizer import Tokenizer

# --------------------------------------------------------------------------
# GPT-2 byte alphabet: every byte maps to a PRINTABLE unicode char so BPE
# merge tables can be stored as plain strings.  Printable ASCII + two Latin-1
# ranges map to themselves; the other 68 bytes shift up past U+0100.
# --------------------------------------------------------------------------


def _byte_alphabet() -> Dict[int, str]:
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAC + 1))
        + list(range(0xAE, 0xFF + 1))
    )
    table: Dict[int, str] = {b: chr(b) for b in keep}
    bump = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + bump)
            bump += 1
    return table


_BYTE_TO_CHAR = _byte_alphabet()
_CHAR_TO_BYTE = {c: b for b, c in _BYTE_TO_CHAR.items()}

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def gpt2_pre_tokenize(text: str) -> List[str]:
    """The GPT-2 pre-token grammar as an explicit scanner.

    Equivalent to the published regex
    ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``
    — written out by hand because stdlib ``re`` lacks ``\\p{..}`` classes.
    Each leading single space fuses onto the following word (" the" is one
    pre-token); a whitespace run followed by text yields all but its last
    character, leaving that one to fuse.
    """
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "'":
            hit = next(
                (s for s in _CONTRACTIONS if text.startswith(s, i)), None
            )
            if hit is not None:
                out.append(hit)
                i += len(hit)
                continue
        j = i
        k = i + 1 if (c == " " and i + 1 < n) else i
        lead = text[k] if k < n else ""
        if lead and lead.isalpha():
            e = k
            while e < n and text[e].isalpha():
                e += 1
            if e > k:
                out.append(text[j:e])
                i = e
                continue
        if lead and lead.isnumeric():
            e = k
            while e < n and text[e].isnumeric():
                e += 1
            out.append(text[j:e])
            i = e
            continue
        if lead and not lead.isspace():
            # ?[^\s\p{L}\p{N}]+ — a run of "other" (punctuation etc.)
            e = k
            while (
                e < n
                and not text[e].isspace()
                and not text[e].isalpha()
                and not text[e].isnumeric()
            ):
                e += 1
            if e > k:
                out.append(text[j:e])
                i = e
                continue
        # whitespace run (c may be ' ' followed by whitespace, or \n etc.)
        e = i
        while e < n and text[e].isspace():
            e += 1
        if e == n or e - i == 1:
            out.append(text[i:e])  # trailing run, or single ws before text
            i = e
        else:
            out.append(text[i : e - 1])  # \s+(?!\S): leave one to fuse
            i = e - 1
    return out


# --------------------------------------------------------------------------
# Core merge loop
# --------------------------------------------------------------------------


class _MergeTable:
    """Ranked pair merges: (a, b) -> rank; lower rank merges first."""

    def __init__(self, merges: Sequence[Tuple[str, str]]):
        self.rank = {tuple(m): r for r, m in enumerate(merges)}

    def apply(self, symbols: List[str]) -> List[str]:
        if len(symbols) < 2:
            return symbols
        while True:
            best_rank = None
            best_i = -1
            for i in range(len(symbols) - 1):
                r = self.rank.get((symbols[i], symbols[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                return symbols
            merged = symbols[best_i] + symbols[best_i + 1]
            # merge EVERY occurrence of this exact pair in one pass (the
            # canonical algorithm's behavior for equal-rank occurrences)
            out: List[str] = []
            i = 0
            while i < len(symbols):
                if (
                    i < len(symbols) - 1
                    and symbols[i] == symbols[best_i]
                    and symbols[i + 1] == symbols[best_i + 1]
                ):
                    out.append(merged)
                    i += 2
                else:
                    out.append(symbols[i])
                    i += 1
            symbols = out


class BPETokenizer(Tokenizer):
    """Merge-ranked BPE over a ``tokenizer.json``-style (vocab, merges).

    ``mode``:
      * ``"byte_level"``: GPT-2/BART — pre-token scanner, byte alphabet.
      * ``"metaspace"``: Llama/Mistral exports — ``" "→"▁"``, dummy prefix,
        whole-text merges, ``<0xNN>`` byte fallback.
    """

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        mode: str = "byte_level",
        unk_token: Optional[str] = None,
        bos_token: Optional[str] = None,
        eos_token: Optional[str] = None,
        pad_token: Optional[str] = None,
        add_bos: Optional[bool] = None,
        add_eos: Optional[bool] = None,
        add_prefix_space: bool = False,
        special_tokens: Sequence[str] = (),
    ):
        if mode not in ("byte_level", "metaspace"):
            raise ValueError(f"unknown BPE mode: {mode}")
        super().__init__(len(vocab), lowercase=False)
        self.mode = mode
        self.vocab = dict(vocab)
        self._inv = {i: t for t, i in self.vocab.items()}
        self._merges = _MergeTable(merges)
        self._cache: Dict[str, List[int]] = {}
        # Whole-text merging is O(len^2) — fine per word, quadratic per
        # document.  Real Llama/Mistral vocabs contain no token with an
        # INTERNAL "▁" (merges never cross word boundaries), so splitting
        # the text at "▁" markers gives identical ids at per-word cost and
        # makes the cache hit (words repeat; whole documents don't).
        # Synthetic/unusual vocabs with cross-word tokens keep the exact
        # whole-text path.
        self._word_split = mode == "metaspace" and not any(
            "▁" in t[1:] for t in self.vocab
        )
        self.add_prefix_space = add_prefix_space
        self.special_tokens = set(special_tokens)

        def _id(tok: Optional[str], *fallbacks: str) -> Optional[int]:
            for cand in (tok, *fallbacks):
                if cand is not None and cand in self.vocab:
                    return self.vocab[cand]
            return None

        self.unk_id = _id(unk_token, "<unk>", "<|endoftext|>")
        self.bos_id = _id(bos_token, "<s>", "<|begin_of_text|>", "<|endoftext|>")
        self.eos_id = _id(eos_token, "</s>", "<|end_of_text|>", "<|endoftext|>")
        pad = _id(pad_token, "<pad>")
        # pad_id must exist for batch(); 0 is only a FILLER value when the
        # vocab has no pad token — decode must then NOT strip id 0 (it is a
        # real token, e.g. "!" in GPT-2-lineage vocabs)
        self._pad_is_real = pad is not None
        self.pad_id = pad if pad is not None else 0
        # BART wraps <s> ... </s>; Llama-lineage prepends <s> only
        self.add_bos = add_bos if add_bos is not None else True
        self.add_eos = (
            add_eos if add_eos is not None else (mode == "byte_level")
        )
        # decode_ids compat with the base class (cls/sep aliases)
        self.cls_id = self.bos_id if self.bos_id is not None else 0
        self.sep_id = self.eos_id if self.eos_id is not None else 0

    # ---- construction ----------------------------------------------------

    @classmethod
    def from_tokenizer_json(cls, path: str) -> "BPETokenizer":
        """Load an HF ``tokenizer.json`` (model.type == "BPE").

        Mode detection: a serialized ByteLevel pre_tokenizer/decoder →
        ``byte_level``; a Metaspace pre_tokenizer or a ``" "→"▁"`` Replace
        normalizer (Llama/Mistral exports) → ``metaspace``.
        """
        with open(path, encoding="utf-8") as f:
            blob = json.load(f)
        model = blob.get("model", {})
        if model.get("type") not in ("BPE", None):
            raise ValueError(
                f"tokenizer.json model.type={model.get('type')!r}; only BPE "
                "is supported here (WordPiece loads via vocab.txt)"
            )
        vocab = model["vocab"]
        merges = [
            tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
            for m in model.get("merges", [])
        ]

        def _flatten(section) -> List[dict]:
            """A serialized component is a dict, possibly a Sequence of
            sub-components under "pretokenizers"/"normalizers"/"decoders"."""
            if not isinstance(section, dict):
                return []
            subs = (
                section.get("pretokenizers")
                or section.get("normalizers")
                or section.get("decoders")
            )
            if isinstance(subs, list):
                return [s for s in subs if isinstance(s, dict)]
            return [section]

        components = (
            _flatten(blob.get("pre_tokenizer"))
            + _flatten(blob.get("normalizer"))
            + _flatten(blob.get("decoder"))
        )
        kinds = {c.get("type") for c in components}
        if model.get("byte_fallback") or "Metaspace" in kinds:
            mode = "metaspace"
        elif "ByteLevel" in kinds:
            mode = "byte_level"
        elif any(
            c.get("type") == "Replace"
            and (c.get("content") == "▁" or c.get("pattern") == {"String": " "})
            for c in components
        ):
            mode = "metaspace"  # Llama-style: only a Replace normalizer
        else:
            mode = "byte_level"
        # the decoder's ByteLevel serializes add_prefix_space=true by
        # default — only the PRE-tokenizer's flag changes the encode
        add_prefix = any(
            c.get("type") == "ByteLevel" and c.get("add_prefix_space")
            for c in _flatten(blob.get("pre_tokenizer"))
        )
        specials = [
            t["content"]
            for t in blob.get("added_tokens", [])
            if t.get("special")
        ]
        # the post_processor template reveals the bos/eos convention:
        # "<s> $A </s>" (BART/RoBERTa) vs "<s> $A" (Llama/Mistral)
        add_bos = None
        add_eos = None
        post = blob.get("post_processor")
        if post:
            post_str = json.dumps(post)
            add_bos = "<s>" in post_str or "begin_of_text" in post_str
            add_eos = "</s>" in post_str or "end_of_text" in post_str
        return cls(
            vocab,
            merges,
            mode=mode,
            unk_token=model.get("unk_token"),
            add_prefix_space=add_prefix,
            special_tokens=specials,
            add_bos=add_bos,
            add_eos=add_eos,
        )

    # ---- encode ----------------------------------------------------------

    _CACHE_MAX_ENTRIES = 100_000
    _CACHE_MAX_KEY = 64

    def _bpe_word(self, mapped: str) -> List[int]:
        """BPE-merge one pre-token already in alphabet space → ids."""
        hit = self._cache.get(mapped)
        if hit is not None:
            return hit
        symbols = self._merges.apply(list(mapped))
        ids: List[int] = []
        for sym in symbols:
            tid = self.vocab.get(sym)
            if tid is None:
                if self.mode == "metaspace":
                    ids.extend(self._byte_fallback(sym))
                    continue
                tid = self.unk_id if self.unk_id is not None else 0
            ids.append(tid)
        # bound the memo: long keys (whole-text mode) never repeat, and a
        # long-running service must not grow this dict without limit
        if len(mapped) <= self._CACHE_MAX_KEY:
            if len(self._cache) >= self._CACHE_MAX_ENTRIES:
                self._cache.clear()
            self._cache[mapped] = ids
        return ids

    def _byte_fallback(self, sym: str) -> List[int]:
        out: List[int] = []
        for b in sym.encode("utf-8"):
            tid = self.vocab.get(f"<0x{b:02X}>")
            if tid is None:
                tid = self.unk_id if self.unk_id is not None else 0
            out.append(tid)
        return out

    def _encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        if self.mode == "byte_level":
            if self.add_prefix_space and text and not text.startswith(" "):
                text = " " + text
            for pre in gpt2_pre_tokenize(text):
                mapped = "".join(
                    _BYTE_TO_CHAR[b] for b in pre.encode("utf-8")
                )
                ids.extend(self._bpe_word(mapped))
        else:
            if not text:
                return ids  # sentencepiece convention: "" → no pieces
            text = "▁" + text.replace(" ", "▁")
            if self._word_split:
                for seg in re.split(r"(?=▁)", text):
                    if seg:
                        ids.extend(self._bpe_word(seg))
            else:
                ids.extend(self._bpe_word(text))
        return ids

    def encode(
        self,
        text: str,
        max_len: Optional[int] = None,
        add_specials: bool = True,
    ) -> List[int]:
        ids = self._encode_text(text)
        if add_specials:
            if self.add_bos and self.bos_id is not None:
                ids = [self.bos_id] + ids
            if self.add_eos and self.eos_id is not None:
                ids = ids + [self.eos_id]
        if max_len is not None and len(ids) > max_len:
            if add_specials and self.add_eos and self.eos_id is not None:
                ids = ids[: max_len - 1] + [self.eos_id]
            else:
                ids = ids[:max_len]
        return ids

    # ---- decode ----------------------------------------------------------

    def decode_ids(self, ids: Sequence[int]) -> str:
        toks: List[str] = []
        byte_run: List[int] = []

        def _flush_bytes():
            if byte_run:
                toks.append(
                    bytes(byte_run).decode("utf-8", errors="replace")
                )
                byte_run.clear()

        specials = {self.bos_id, self.eos_id}
        if self._pad_is_real:
            specials.add(self.pad_id)
        for i in ids:
            tok = self._inv.get(int(i))
            if tok is None or int(i) in specials or tok in self.special_tokens:
                continue
            if (
                self.mode == "metaspace"
                and len(tok) == 6
                and tok.startswith("<0x")
                and tok.endswith(">")
            ):
                byte_run.append(int(tok[3:5], 16))
                continue
            _flush_bytes()
            toks.append(tok)
        _flush_bytes()
        text = "".join(toks)
        if self.mode == "byte_level":
            data = bytes(
                _CHAR_TO_BYTE.get(c, ord("?")) for c in text
            )
            return data.decode("utf-8", errors="replace")
        text = text.replace("▁", " ")
        # encode prepended exactly one dummy-prefix space; remove exactly one
        return text[1:] if text.startswith(" ") else text


# --------------------------------------------------------------------------
# SentencePiece .model — minimal protobuf wire parser (no dependency)
# --------------------------------------------------------------------------

_SP_NORMAL, _SP_UNKNOWN, _SP_CONTROL, _SP_USER, _SP_UNUSED, _SP_BYTE = (
    1,
    2,
    3,
    4,
    5,
    6,
)


def _pb_varint(buf: bytes, i: int) -> Tuple[int, int]:
    val = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _pb_fields(buf: bytes):
    """Yield (field_no, wire_type, value) over one message's wire bytes."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _pb_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, i = _pb_varint(buf, i)
        elif wire == 1:
            val, i = buf[i : i + 8], i + 8
        elif wire == 2:
            ln, i = _pb_varint(buf, i)
            val, i = buf[i : i + ln], i + ln
        elif wire == 5:
            val, i = buf[i : i + 4], i + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


class SentencePieceTokenizer(Tokenizer):
    """Tokenizer over a raw SentencePiece ``tokenizer.model`` protobuf.

    Parses ``ModelProto`` directly: field 1 = repeated ``SentencePiece``
    (piece/score/type), field 2 = ``TrainerSpec`` (model_type: 1 unigram,
    2 BPE).  BPE models tokenize by iteratively merging the adjacent pair
    whose concatenation scores best (scores encode merge rank); unigram
    models take the max-sum-of-scores segmentation via Viterbi.  Unknown
    characters fall back to ``<0xNN>`` byte pieces when present.
    """

    def __init__(
        self,
        pieces: Sequence[Tuple[str, float, int]],
        model_type: int = 2,
        add_bos: bool = True,
        add_eos: bool = False,
    ):
        super().__init__(len(pieces), lowercase=False)
        self.model_type = model_type
        self.add_bos = add_bos
        self.add_eos = add_eos
        self.vocab: Dict[str, int] = {}
        self.score: Dict[str, float] = {}
        self._inv: Dict[int, str] = {}
        self._types: Dict[int, int] = {}
        self.unk_id = 0
        self.bos_id: Optional[int] = None
        self.eos_id: Optional[int] = None
        self.pad_id = 0
        self._byte_ids: Dict[int, int] = {}
        for idx, (piece, score, ptype) in enumerate(pieces):
            self.vocab[piece] = idx
            self.score[piece] = score
            self._inv[idx] = piece
            self._types[idx] = ptype
            if ptype == _SP_UNKNOWN:
                self.unk_id = idx
            elif ptype == _SP_CONTROL:
                if piece == "<s>":
                    self.bos_id = idx
                elif piece == "</s>":
                    self.eos_id = idx
                elif piece == "<pad>":
                    self.pad_id = idx
            elif ptype == _SP_BYTE:
                self._byte_ids[int(piece[3:5], 16)] = idx
        self.cls_id = self.bos_id if self.bos_id is not None else 0
        self.sep_id = self.eos_id if self.eos_id is not None else 0
        self._max_piece_len = max((len(p) for p in self.vocab), default=1)
        # same boundedness argument as BPETokenizer._word_split: when no
        # piece carries an internal "▁" (every real Llama/Mistral model),
        # segmenting at word markers is id-identical and turns the O(n^2)
        # whole-text merge into per-word cost
        self._word_split = not any(
            "▁" in p[1:] for p in self.vocab if not p.startswith("<0x")
        )

    @classmethod
    def from_file(cls, path: str, **kw) -> "SentencePieceTokenizer":
        with open(path, "rb") as f:
            buf = f.read()
        pieces: List[Tuple[str, float, int]] = []
        model_type = 2
        for field, wire, val in _pb_fields(buf):
            if field == 1 and wire == 2:  # SentencePiece submessage
                piece, score, ptype = "", 0.0, _SP_NORMAL
                for f2, w2, v2 in _pb_fields(val):
                    if f2 == 1 and w2 == 2:
                        piece = v2.decode("utf-8")
                    elif f2 == 2 and w2 == 5:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3 and w2 == 0:
                        ptype = v2
                pieces.append((piece, score, ptype))
            elif field == 2 and wire == 2:  # TrainerSpec
                for f2, w2, v2 in _pb_fields(val):
                    if f2 == 3 and w2 == 0:  # model_type
                        model_type = v2
        return cls(pieces, model_type=model_type, **kw)

    # ---- encode ----------------------------------------------------------

    def _initial_symbols(self, text: str) -> List[str]:
        return list("▁" + text.replace(" ", "▁"))

    def _sp_bpe(self, symbols: List[str]) -> List[str]:
        while len(symbols) > 1:
            best_score = None
            best_i = -1
            for i in range(len(symbols) - 1):
                cand = symbols[i] + symbols[i + 1]
                s = self.score.get(cand)
                if s is not None and (best_score is None or s > best_score):
                    best_score, best_i = s, i
            if best_score is None:
                break
            symbols[best_i : best_i + 2] = [
                symbols[best_i] + symbols[best_i + 1]
            ]
        return symbols

    def _viterbi(self, text: str) -> List[str]:
        n = len(text)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: List[Tuple[int, str]] = [(0, "")] * (n + 1)
        best[0] = 0.0
        for e in range(1, n + 1):
            for s in range(max(0, e - self._max_piece_len), e):
                if best[s] == NEG:
                    continue
                piece = text[s:e]
                sc = self.score.get(piece)
                if sc is None:
                    if e - s == 1:  # unk single char, heavy penalty
                        sc = -1e4
                    else:
                        continue
                if best[s] + sc > best[e]:
                    best[e] = best[s] + sc
                    back[e] = (s, piece)
        pieces: List[str] = []
        e = n
        while e > 0:
            s, piece = back[e]
            pieces.append(piece or text[e - 1 : e])
            e = s if piece else e - 1
        return pieces[::-1]

    def _encode_text(self, text: str) -> List[int]:
        marked = "▁" + text.replace(" ", "▁")
        if self.model_type == 1:
            symbols = self._viterbi(marked)
        elif self._word_split:
            symbols = []
            for seg in re.split(r"(?=▁)", marked):
                if seg:
                    symbols.extend(self._sp_bpe(list(seg)))
        else:
            symbols = self._sp_bpe(self._initial_symbols(text))
        ids: List[int] = []
        for sym in symbols:
            tid = self.vocab.get(sym)
            if tid is not None:
                ids.append(tid)
            elif self._byte_ids:
                ids.extend(
                    self._byte_ids.get(b, self.unk_id)
                    for b in sym.encode("utf-8")
                )
            else:
                ids.append(self.unk_id)
        return ids

    def encode(
        self,
        text: str,
        max_len: Optional[int] = None,
        add_specials: bool = True,
    ) -> List[int]:
        ids = self._encode_text(text)
        if add_specials:
            if self.add_bos and self.bos_id is not None:
                ids = [self.bos_id] + ids
            if self.add_eos and self.eos_id is not None:
                ids = ids + [self.eos_id]
        if max_len is not None:
            ids = ids[:max_len]
        return ids

    def decode_ids(self, ids: Sequence[int]) -> str:
        toks: List[str] = []
        byte_run: List[int] = []

        def _flush():
            if byte_run:
                toks.append(bytes(byte_run).decode("utf-8", errors="replace"))
                byte_run.clear()

        for i in ids:
            i = int(i)
            ptype = self._types.get(i)
            if ptype in (_SP_CONTROL, _SP_UNKNOWN, _SP_UNUSED):
                continue
            if ptype == _SP_BYTE:
                byte_run.append(int(self._inv[i][3:5], 16))
                continue
            _flush()
            tok = self._inv.get(i)
            if tok is not None:
                toks.append(tok)
        _flush()
        text = "".join(toks).replace("▁", " ")
        return text[1:] if text.startswith(" ") else text


# --------------------------------------------------------------------------
# Dispatch
# --------------------------------------------------------------------------


def load_tokenizer(path: str) -> Tokenizer:
    """Dispatch on the vocabulary file: ``tokenizer.json`` → BPE,
    ``*.model`` → SentencePiece, ``*.txt`` → WordPiece."""
    from docqa_tpu_torch.text.tokenizer import WordPieceTokenizer

    if path.endswith(".json"):
        return BPETokenizer.from_tokenizer_json(path)
    if path.endswith(".model"):
        return SentencePieceTokenizer.from_file(path)
    if path.endswith(".txt"):
        return WordPieceTokenizer.from_file(path)
    raise ValueError(
        f"unrecognized tokenizer file {path!r} (want .json/.model/.txt)"
    )
