"""A frozen copy of the port's hash tokenizer and its ``/ask`` prompt
template, so the reference builds prompt ids on its own.

Words and punctuation split by ``\\w+|[^\\w\\s]`` after lower-casing; each
piece is one id, an FNV-1a bucket above the five reserved ids; ``encode``
wraps the ids in 2 (start) and 3 (end).
"""

from __future__ import annotations

import re
from typing import List, Sequence

N_RESERVED = 5
START_ID, END_ID = 2, 3

_WORD_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)

QA_TEMPLATE = (
    "Tu es un expert en médecine traditionnelle chinoise et en analyse de "
    "dossiers cliniques. Appuie-toi uniquement sur le contexte ci-dessous. "
    "Quand plusieurs éléments portent un score, privilégie les scores les "
    "plus élevés et mentionne-les. Si le contexte ne permet pas de répondre, "
    "dis-le explicitement.\n\n"
    "Contexte:\n{context}\n\nQuestion: {question}\n\nRéponse:"
)


def _fnv1a(s: str) -> int:
    h = 0xCBF29CE484222325
    for byte in s.encode("utf-8"):
        h ^= byte
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def pieces(text: str) -> List[str]:
    return _WORD_RE.findall(text.lower())


def encode(text: str, vocab_size: int, max_len: int = 0) -> List[int]:
    """Start id, one id a piece, end id; with ``max_len`` the pieces are cut
    so that the whole fits."""
    words = pieces(text)
    if max_len:
        words = words[: max_len - 2]
    span = vocab_size - N_RESERVED
    return [START_ID] + [N_RESERVED + _fnv1a(w) % span for w in words] + [END_ID]


def prompt_text(question: str, chunks: Sequence[str]) -> str:
    return QA_TEMPLATE.format(context="\n\n".join(chunks), question=question)
