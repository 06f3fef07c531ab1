"""Document chunking, counterpart of ``docqa_tpu/text/chunker.py`` (verbatim).

The reference used fixed 500-char non-overlapping slices
(``semantic-indexer/indexer.py:120``) which split words and sentences mid-way.
Defaults here reproduce that budget (``ChunkConfig.chunk_chars=500``) but
snap the cut to the last whitespace/sentence boundary inside a lookback
window, and support overlap so context at chunk edges isn't lost to
retrieval.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from docqa_tpu_torch.config import ChunkConfig

_BOUNDARY_CHARS = ".!?\n"


@dataclass(frozen=True)
class Chunk:
    text: str
    start: int  # char offset in the source document
    end: int


def chunk_text(
    text: str,
    cfg: Optional[ChunkConfig] = None,
    snap_window: int = 80,
) -> List[Chunk]:
    """Slice ``text`` into ~chunk_chars pieces.

    Cut preference inside the trailing ``snap_window`` chars of each slice:
    sentence boundary > whitespace > hard cut (reference behavior).
    ``overlap_chars`` > 0 makes consecutive chunks share a prefix.
    """
    cfg = cfg or ChunkConfig()
    size, overlap = cfg.chunk_chars, cfg.overlap_chars
    if size <= 0:
        raise ValueError("chunk_chars must be positive")
    if overlap >= size:
        raise ValueError("overlap_chars must be < chunk_chars")
    out: List[Chunk] = []
    pos = 0
    n = len(text)
    while pos < n:
        end = min(pos + size, n)
        if end < n and snap_window > 0:
            window = text[max(pos, end - snap_window) : end]
            cut = -1
            for i in range(len(window) - 1, -1, -1):
                if window[i] in _BOUNDARY_CHARS:
                    cut = i + 1  # keep the boundary char in this chunk
                    break
            if cut < 0:
                sp = window.rfind(" ")
                cut = sp + 1 if sp > 0 else -1
            if cut > 0:
                end = max(pos, end - snap_window) + cut
        piece = text[pos:end]
        if piece.strip():
            out.append(Chunk(piece, pos, end))
        if end >= n:
            break
        pos = max(end - overlap, pos + 1)
    return out
