"""Patient synthesis and comparison service, counterpart of
``docqa_tpu/service/synthesis.py``.

Retrieval and summarization are injected: ``retrieval`` is
``QAService.patient_snippets`` (or :func:`fake_patient_retrieval` in
standalone mode), ``summarizer`` a ``SummarizeEngine``.  The split
``*_submit`` methods let the HTTP layer run retrieval and the summary's
submission on its device lane and the wait for the decode on its wait
lane.  Sections, key points, the comparison table and the source cuts
(5 snippets of 300 characters; 3 documents a patient; 10 sources) are the
reference's.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from docqa_tpu_torch.service.schemas import (
    ComparisonRow,
    MultiPatientComparisonResponse,
    Section,
    SinglePatientSummaryResponse,
    SourceSnippet,
)


class SynthesisError(Exception):
    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


def fake_patient_retrieval(
    patient_id: str,
    from_date: Optional[str] = None,
    to_date: Optional[str] = None,
    focus: Optional[str] = None,
) -> List[Dict[str, str]]:
    """Canned snippets for standalone mode (``flags.use_fake_retrieval``):
    ``[{doc_id, text}]``, two of them for any patient id, equal to the
    reference's."""
    del from_date, to_date, focus
    return [
        {
            "doc_id": f"fake-{patient_id}-1",
            "text": (
                f"Consultation du patient {patient_id} : tension artérielle "
                "142/88 mmHg, céphalées intermittentes depuis deux semaines. "
                "Traitement par amlodipine 5 mg instauré."
            ),
        },
        {
            "doc_id": f"fake-{patient_id}-2",
            "text": (
                f"Suivi du patient {patient_id} : bilan biologique sans "
                "anomalie, HbA1c 6,1 %. Poursuite du traitement en cours, "
                "contrôle dans trois mois."
            ),
        },
    ]


_SECTION_TITLES = (
    "Contexte clinique",
    "Éléments marquants",
    "Évolution",
    "Points de vigilance",
)


def _split_sections(summary: str) -> List[Section]:
    """Best-effort split of the generated summary on the four requested
    headings; falls back to one section."""
    marks: List[Tuple[int, str]] = []
    low = summary.lower()
    for title in _SECTION_TITLES:
        i = low.find(title.lower())
        if i >= 0:
            marks.append((i, title))
    marks.sort()
    if len(marks) < 2:
        return [Section(title="Synthèse", content=summary.strip())]
    out = []
    for j, (i, title) in enumerate(marks):
        end = marks[j + 1][0] if j + 1 < len(marks) else len(summary)
        content = summary[i + len(title) : end].strip(" :\n-—")
        out.append(Section(title=title, content=content))
    return out


def _key_points(docs: Sequence[Dict[str, str]], limit: int = 5) -> List[str]:
    """Extract short factual lines (scores, measurements, dated events) from
    the retrieved snippets."""
    import re

    points: List[str] = []
    seen = set()
    pattern = re.compile(
        r"[^.\n]*(?:\d+[.,]?\d*\s*(?:%|mg|ml|mmhg|°c|kg)|score\s*[:=]?\s*\d|"
        r"\d{4}-\d{2}-\d{2})[^.\n]*",
        re.IGNORECASE,
    )
    for d in docs:
        for m in pattern.finditer(d.get("text", "")):
            line = m.group().strip()
            if 10 < len(line) < 200 and line.lower() not in seen:
                seen.add(line.lower())
                points.append(line)
            if len(points) >= limit:
                return points
    return points


class SynthesisService:
    def __init__(self, retrieval, summarizer) -> None:
        """``retrieval``: callable(patient_id, from_date, to_date, focus) →
        [{doc_id, text}] (QAService.patient_snippets or an HTTP client).
        ``summarizer``: SummarizeEngine or a compatible fake."""
        self.retrieval = retrieval
        self.summarizer = summarizer

    # ---- POST /api/synthese/patient -----------------------------------------

    def patient_summary_submit(
        self,
        patient_id: str,
        from_date: Optional[str] = None,
        to_date: Optional[str] = None,
        focus: Optional[str] = None,
    ) -> Callable[[], SinglePatientSummaryResponse]:
        """Retrieval + summary *submission*; the returned thunk waits for the
        decode and assembles the response.  The HTTP layer runs this on the
        device lane and the thunk on the wait lane, so concurrent synthesis
        requests share batcher slots without dispatching retrieval programs
        from multiple threads."""
        docs = self.retrieval(patient_id, from_date, to_date, focus)
        if not docs:
            raise SynthesisError(
                404, f"no documents found for patient {patient_id}"
            )
        pending = self.summarizer.submit_patient(
            patient_id, [(d["doc_id"], d["text"]) for d in docs]
        )

        def finish() -> SinglePatientSummaryResponse:
            summary = self.summarizer.resolve(pending)
            return SinglePatientSummaryResponse(
                patient_id=patient_id,
                sections=_split_sections(summary),
                key_points=_key_points(docs),
                sources=[
                    SourceSnippet(doc_id=d["doc_id"], snippet=d["text"][:300])
                    for d in docs[:5]
                ],
            )

        return finish

    def patient_comparison_submit(
        self,
        patient_ids: Sequence[str],
        focus: Optional[str] = None,
    ) -> Callable[[], MultiPatientComparisonResponse]:
        if len(patient_ids) < 2:
            raise SynthesisError(
                400, "at least two patient_ids are required"
            )
        per_patient: List[Tuple[str, List[Dict[str, str]]]] = []
        for pid in patient_ids:
            docs = self.retrieval(pid, None, None, focus)
            per_patient.append((pid, docs[:3]))  # 3 per patient
        if all(not docs for _, docs in per_patient):
            raise SynthesisError(404, "no documents found for any patient")
        pending = self.summarizer.submit_compare(
            [
                (pid, [(d["doc_id"], d["text"]) for d in docs])
                for pid, docs in per_patient
            ]
        )

        def finish() -> MultiPatientComparisonResponse:
            summary = self.summarizer.resolve(pending)
            return self._assemble_comparison(patient_ids, per_patient, summary)

        return finish

    def _assemble_comparison(
        self,
        patient_ids: Sequence[str],
        per_patient: List[Tuple[str, List[Dict[str, str]]]],
        summary: str,
    ) -> MultiPatientComparisonResponse:
        table = [
            ComparisonRow(
                criterion="documents_retrieved",
                values={pid: len(docs) for pid, docs in per_patient},
            ),
            ComparisonRow(
                criterion="key_points",
                values={
                    pid: "; ".join(_key_points(docs, 3)) or "—"
                    for pid, docs in per_patient
                },
            ),
        ]
        sources: List[SourceSnippet] = []
        for pid, docs in per_patient:
            sources.extend(
                SourceSnippet(doc_id=d["doc_id"], snippet=d["text"][:300])
                for d in docs
            )
        return MultiPatientComparisonResponse(
            patient_ids=list(patient_ids),
            summary=summary,
            comparison_table=table,
            sources=sources[:10],
        )
