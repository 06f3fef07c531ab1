"""Confidence-gated answer routing and dense/lexical score fusion,
counterpart of ``docqa_tpu/engines/router.py``.  Host logic only:

* :func:`extractive_answer`: the top-k retrieved chunks verbatim.  It
  serves the degraded ``/ask`` answer when generation is down
  (``service/qa.py``) and the routed lookup answer at full health.
* :func:`fuse_scores`: the ``hybrid`` retrieve mode's merge, ``alpha *
  norm(dense) + (1 - alpha) * norm(lexical)`` over the candidate union,
  each tier min-max normalized over its own candidates.
* :class:`AnswerRouter`: classifies each ``/ask`` from its text as a lookup
  (the answer is a span the index holds: an MRN or phone number, a quoted
  string, "what is the dose of X" in EN/FR) or generative (why, how,
  explain, summarize).  A lookup is checked again after retrieval
  (:meth:`AnswerRouter.evidence_gate`, :func:`extractive_confidence`); low
  confidence at either stage falls through to the decoder, so a wrong route
  costs latency, never correctness.  A routed answer makes no decode.

Cue lists, thresholds and the calibration are the reference's.
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from docqa_tpu_torch.index.lexical import clinical_tokens

ROUTE_EXTRACTIVE = "extractive"
ROUTE_GENERATIVE = "generative"


def extractive_answer(chunks: List[str], max_chars: int = 600) -> str:
    """The top-k retrieved chunks verbatim, joined by blank lines and cut
    at ``max_chars``; deterministic and model-free.  Byte-identical to the
    reference's."""
    text = "\n\n".join(c for c in chunks if c).strip()
    if not text:
        return "Aucun contexte trouvé."
    return text[:max_chars]


# EN + FR function words left out of the evidence overlap
_STOPWORDS = frozenset(
    """a an and are as at be by for from in is it of on or that the to was
    what when where which who with
    au aux ce cette dans de des du en est et il elle la le les ou par pour
    que quel quelle qui sur un une""".split()
)


def extractive_confidence(question: str, chunks: Sequence[str]) -> float:
    """Evidence confidence in [0, 1]: how much of the question's content
    vocabulary the retrieved context holds.  A digit run of five or more
    digits missing from the context caps it at 0.25; coverage maps
    piecewise so the 0.5 threshold sits near 80 % coverage."""
    if not chunks:
        return 0.0
    q_toks = [t for t in clinical_tokens(question) if t not in _STOPWORDS]
    if not q_toks:
        return 0.0
    ctx = set(clinical_tokens(" ".join(c for c in chunks if c)))
    need = set(q_toks)
    coverage = len(need & ctx) / len(need)
    digit_terms = {t for t in need if len(t) >= 5 and t.isdigit()}
    if digit_terms and not digit_terms <= ctx:
        return min(coverage, 0.25)
    if coverage >= 0.95:
        return 1.0
    if coverage <= 0.4:
        return coverage * 0.5
    return 0.2 + (coverage - 0.4) / 0.55 * 0.75


def _minmax(pairs: Sequence[Tuple[float, int]]) -> Dict[int, float]:
    if not pairs:
        return {}
    scores = [s for s, _ in pairs]
    lo, hi = min(scores), max(scores)
    if hi - lo < 1e-12:
        return {rid: 1.0 for _, rid in pairs}
    return {rid: (s - lo) / (hi - lo) for s, rid in pairs}


def fuse_scores(
    dense: Sequence[Tuple[float, int]],
    lexical: Sequence[Tuple[float, int]],
    alpha: float,
    k: Optional[int] = None,
) -> List[Tuple[float, int]]:
    """Hybrid merge over the candidate union; a row only one tier surfaced
    scores 0 on the other.  Ties break on the row id."""
    nd = _minmax(dense)
    nl = _minmax(lexical)
    fused = [
        (alpha * nd.get(rid, 0.0) + (1.0 - alpha) * nl.get(rid, 0.0), rid)
        for rid in nd.keys() | nl.keys()
    ]
    fused.sort(key=lambda p: (-p[0], p[1]))
    return fused[:k] if k is not None else fused


@dataclass(frozen=True)
class RouteDecision:
    route: str  # ROUTE_EXTRACTIVE | ROUTE_GENERATIVE
    confidence: float
    reason: str


def _fold(text: str) -> str:
    t = unicodedata.normalize("NFKD", text.casefold())
    return "".join(ch for ch in t if not unicodedata.combining(ch))


# reasoning cues, checked first: "why was patient 12345678 readmitted"
# holds an MRN but is a generative question about it
_GENERATIVE_CUES = (
    "why", "how ", "how?", "explain", "summar", "compare", "interpret",
    "recommend", "should ", "describe", "what would", "what could",
    "assess", "evaluate", "discuss", "implication", "differen", "risk",
    "likely", "opinion", "advise", "suggest",
    "pourquoi", "comment ", "expliqu", "resum", "compar", "interpret",
    "recommand", "devrait", "faut-il", "analyse", "decri", "justifi",
    "synthese", "synthet", "evalu", "consequence", "avis", "conseil",
)

# lookup cues: the answer is a stored span (EN + diacritic-folded FR)
_LOOKUP_CUES = (
    "mrn", "medical record", "record number", "phone", "telephone",
    "date of birth", "dob", "room number", "dosage", "dose of",
    "what is the dose", "blood type", "allergies", "allergy",
    "admission date", "discharge date", "lookup", "look up",
    "id of", "number of the patient", "contact number",
    "numero de dossier", "numero de telephone", "quel est le numero",
    "quelle est la dose", "posologie", "groupe sanguin",
    "date de naissance", "date d'admission", "date de sortie",
    "chambre", "identifiant",
)

_DIGIT_RUN = re.compile(r"\d[\d.\-\s]{4,}\d")
_QUOTED = re.compile(r"[\"«'']([^\"»'']{3,})[\"»'']")


class AnswerRouter:
    """The text-stage decision (:meth:`decide`) and the post-retrieval
    evidence gate (:meth:`evidence_gate`, applied by the QA service).
    Decisions below ``min_confidence`` take the generative path."""

    def __init__(
        self,
        min_confidence: float = 0.7,
        evidence_min: float = 0.5,
        enabled: bool = True,
    ) -> None:
        self.min_confidence = float(min_confidence)
        self.evidence_min = float(evidence_min)
        self.enabled = bool(enabled)

    def decide(self, question: str) -> RouteDecision:
        """Any reasoning cue forces generative; then a digit run, a quoted
        string or a lookup cue makes a lookup."""
        if not self.enabled:
            return RouteDecision(ROUTE_GENERATIVE, 1.0, "router_disabled")
        q = _fold(question or "").strip()
        if not q:
            return RouteDecision(ROUTE_GENERATIVE, 1.0, "empty_question")
        for cue in _GENERATIVE_CUES:
            if cue in q:
                return RouteDecision(
                    ROUTE_GENERATIVE, 0.9, f"generative_cue:{cue.strip()}"
                )
        if _DIGIT_RUN.search(q):
            return RouteDecision(ROUTE_EXTRACTIVE, 0.9, "digit_run")
        if _QUOTED.search(q):
            return RouteDecision(ROUTE_EXTRACTIVE, 0.85, "quoted_exact")
        hits = [cue for cue in _LOOKUP_CUES if cue in q]
        if hits:
            conf = min(0.95, 0.75 + 0.05 * (len(hits) - 1))
            return RouteDecision(ROUTE_EXTRACTIVE, conf, f"lookup_cue:{hits[0]}")
        return RouteDecision(ROUTE_GENERATIVE, 0.6, "default_generative")

    def evidence_gate(
        self, decision: RouteDecision, question: str, chunks: Sequence[str]
    ) -> Tuple[RouteDecision, float]:
        """Re-check a lookup decision against what retrieval found:
        returns the (possibly demoted) decision and the evidence
        confidence."""
        ev = extractive_confidence(question, chunks)
        if decision.route != ROUTE_EXTRACTIVE:
            return decision, ev
        if decision.confidence < self.min_confidence:
            return (
                RouteDecision(
                    ROUTE_GENERATIVE, decision.confidence, "below_min_confidence"
                ),
                ev,
            )
        if ev < self.evidence_min:
            return RouteDecision(ROUTE_GENERATIVE, ev, "low_evidence"), ev
        return decision, ev
