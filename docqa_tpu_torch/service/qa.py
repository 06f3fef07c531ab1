"""QA / RAG service core on the solo path: retrieval -> prompt -> generation.
Counterpart of ``docqa_tpu/service/qa.py``'s ``QAService.ask`` with no
batcher, router, fused RAG lane or fake LLM.

There is no degraded-answer fallback here: a generation error propagates,
so a kernel that fails to build or launch is never hidden behind an
extractive answer.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from docqa_tpu_torch.engines.encoder import EncoderEngine
from docqa_tpu_torch.engines.generate import GenerateEngine
from docqa_tpu_torch.engines.retrieve import FusedRetriever
from docqa_tpu_torch.index.store import VectorStore
from docqa_tpu_torch.utils import resolve_device

# Copied verbatim from docqa_tpu/service/qa.py.
QA_TEMPLATE = (
    "Tu es un expert en médecine traditionnelle chinoise et en analyse de "
    "dossiers cliniques. Appuie-toi uniquement sur le contexte ci-dessous. "
    "Quand plusieurs éléments portent un score, privilégie les scores les "
    "plus élevés et mentionne-les. Si le contexte ne permet pas de répondre, "
    "dis-le explicitement.\n\n"
    "Contexte:\n{context}\n\nQuestion: {question}\n\nRéponse:"
)


class QAService:
    def __init__(
        self,
        encoder: EncoderEngine,
        store: VectorStore,
        generator: GenerateEngine,
        k: int = 3,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        if generator.device != self.device:
            raise ValueError(
                f"generator on {generator.device}; the service runs on "
                f"{self.device}"
            )
        self.retriever = FusedRetriever(encoder, store, device=self.device)
        self.generator = generator
        self.k = k

    def ask(self, question: str, k: Optional[int] = None) -> Dict[str, Any]:
        """The reference's response contract ``{"answer", "sources"}``."""
        hits = self.retriever.search_texts([question], k=k or self.k)[0]
        chunks = [
            h.metadata.get("text_content", h.metadata.get("source", ""))
            for h in hits
        ]
        context = "\n\n".join(chunks)
        prompt = QA_TEMPLATE.format(context=context, question=question)
        sources = [h.metadata.get("source", "") for h in hits]
        answer = self.generator.generate_texts([prompt])[0]
        return {"answer": answer, "sources": sources}
