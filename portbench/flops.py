"""The yardstick's arithmetic: peaks, operation and byte counts.

A frozen copy of the analytic counts of the port's ``obs/observatory.py``
(linear layers ``2*m*n*k``; attention ``4*d*hq*pairs`` over live causal
pairs), kept here so that a change to the program cannot move the yardstick.
Widths come from a :class:`ModelShape`, built from a configuration file.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

# NVIDIA's data sheet, H100 SXM, dense: bf16 tensor-core FLOP/s
PEAK_FLOPS = 989e12


@dataclass(frozen=True)
class ModelShape:
    vocab: int
    hidden: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    mlp: int
    window: Optional[int] = None
    weight_bits: int = 16  # 16: bf16 projections; 8: int8 per column

    def projections(self) -> List[Tuple[str, int, int]]:
        """(name, in, out) of one layer's projections."""
        h, qd, kvd = self.hidden, self.heads * self.head_dim, self.kv_heads * self.head_dim
        return [("wq", h, qd), ("wk", h, kvd), ("wv", h, kvd), ("wo", qd, h),
                ("w_gate", h, self.mlp), ("w_up", h, self.mlp), ("w_down", self.mlp, h)]


def causal_pairs(start: int, end: int, window: Optional[int] = None) -> int:
    """Live (query, key) pairs of positions [start, end) attending causally
    from position 0, at most ``window`` keys each."""
    if end <= start:
        return 0
    if not window or end <= window:
        return (end * (end + 1) - start * (start + 1)) // 2
    return sum(min(p + 1, window) for p in range(start, end))


def linear_flops(m: ModelShape, rows: int, logit_rows: int) -> float:
    """Every layer's projections over ``rows`` tokens, and the lm head over
    ``logit_rows``."""
    per_token = sum(2 * i * o for _, i, o in m.projections())
    return float(rows * m.layers * per_token + logit_rows * 2 * m.hidden * m.vocab)


def attention_flops(m: ModelShape, pairs: int) -> float:
    return 4.0 * m.head_dim * m.heads * pairs * m.layers


def sequence_flops(m: ModelShape, start: int, end: int, logit_rows: int) -> float:
    """Tokens at positions [start, end) through the model once, with
    ``logit_rows`` rows through the head."""
    return (linear_flops(m, end - start, logit_rows)
            + attention_flops(m, causal_pairs(start, end, m.window)))


def prompt_flops(m: ModelShape, n_prompt: int) -> float:
    """A prompt's prefill: its tokens once, its last row through the head."""
    return sequence_flops(m, 0, n_prompt, 1)


def ask_flops(m: ModelShape, n_prompt: int, n_answer: int) -> float:
    """A whole answer, each token once whatever was cached or drafted: the
    prompt and every answer token but the last through the model, and one
    head row a produced token."""
    return sequence_flops(m, 0, n_prompt + max(n_answer - 1, 0), max(n_answer, 1))


def mfu_share(flops: float, seconds: float) -> Optional[float]:
    """FLOPs over seconds as a percentage of the bf16 peak; None without time."""
    if seconds <= 0:
        return None
    return 100.0 * flops / seconds / PEAK_FLOPS
