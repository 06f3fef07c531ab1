"""QA / RAG service core: retrieval -> prompt -> generation.  Counterpart
of ``docqa_tpu/service/qa.py``'s ``QAService`` (``ask_submit`` / ``ask``)
without the router, the fused RAG lane or the fake LLM.

With a ``ContinuousBatcher`` wired in (the reference's default), ``ask``
submits the prompt to it, keyed for the prefix cache by
:func:`prefix_key_for` when the batcher's cache is on, and concurrent
questions share its decode slots; without one, generation is the solo
``GenerateEngine``.

There is no degraded-answer fallback here: a generation or batcher error
propagates, so a kernel that fails to build or launch is never hidden
behind an extractive answer.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from docqa_tpu_torch.engines.encoder import EncoderEngine
from docqa_tpu_torch.engines.generate import GenerateEngine
from docqa_tpu_torch.engines.retrieve import FusedRetriever
from docqa_tpu_torch.engines.serve import DEFAULT_RESULT_TIMEOUT, Handle
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

# template half of the prefix-cache key: a template edit invalidates every
# cached prefix by key
_TEMPLATE_HASH = hashlib.sha1(QA_TEMPLATE.encode("utf-8")).hexdigest()[:12]


def prefix_key_for(chunks: List[str]) -> str:
    """The (template hash, retrieved-chunk-set hash) prefix-cache key:
    consecutive questions against the same retrieved chunks share the whole
    template + context prompt prefix.  Order-sensitive, as the prompt is.
    Same value as the reference's ``prefix_key_for``."""
    h = hashlib.sha1()
    for c in chunks:
        h.update(c.encode("utf-8", "surrogatepass"))
        h.update(b"\x1f")
    return f"{_TEMPLATE_HASH}:{h.hexdigest()[:16]}"


@dataclass
class PendingAnswer:
    """An ``/ask`` answer in flight: retrieval is done, generation may
    still be decoding in the batcher; :meth:`resolve` waits for it."""

    sources: List[str]
    answer: Optional[str] = None  # already final (solo path)
    handle: Optional[Handle] = None  # the batcher's handle
    tokenizer: Optional[Any] = None

    def resolve(self, timeout: Optional[float] = DEFAULT_RESULT_TIMEOUT) -> Dict[str, Any]:
        """The reference's response contract ``{"answer", "sources"}``."""
        answer = self.answer
        if answer is None:
            answer = self.handle.text(self.tokenizer, timeout)
        return {"answer": answer, "sources": self.sources}


class QAService:
    def __init__(
        self,
        encoder: EncoderEngine,
        store: VectorStore,
        generator: GenerateEngine,
        k: int = 3,
        device="cuda",
        batcher=None,
    ) -> None:
        self.device = resolve_device(device)
        for name, part in (("generator", generator), ("batcher", batcher)):
            if part is not None and part.device != self.device:
                raise ValueError(
                    f"{name} on {part.device}; the service runs on "
                    f"{self.device}"
                )
        self.retriever = FusedRetriever(encoder, store, device=self.device)
        self.generator = generator
        self.batcher = batcher
        self.k = k

    def ask_submit(self, question: str, k: Optional[int] = None) -> PendingAnswer:
        """Retrieval, prompt assembly and generation SUBMISSION: with a
        batcher this returns once the prompt is queued."""
        hits = self.retriever.search_texts([question], k=k or self.k)[0]
        chunks = [
            h.metadata.get("text_content", h.metadata.get("source", ""))
            for h in hits
        ]
        context = "\n\n".join(chunks)
        prompt = QA_TEMPLATE.format(context=context, question=question)
        sources = [h.metadata.get("source", "") for h in hits]
        if self.batcher is not None:
            kw = {}
            if self.batcher.prefix_cache_enabled:
                kw["prefix_key"] = prefix_key_for(chunks)
            return PendingAnswer(
                sources=sources,
                handle=self.batcher.submit_text(prompt, **kw),
                tokenizer=self.batcher.engine.tokenizer,
            )
        answer = self.generator.generate_texts([prompt])[0]
        return PendingAnswer(sources=sources, answer=answer)

    def ask(self, question: str, k: Optional[int] = None) -> Dict[str, Any]:
        """The reference's response contract ``{"answer", "sources"}``."""
        return self.ask_submit(question, k).resolve()
